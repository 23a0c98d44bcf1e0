"""K2 and K2-bwd: SFConv frequency branch, forward and backward, as CUDA
kernels (unidefense_tpu/ops/sfconv_pallas.py:136-293, ``sfconv_freq_pallas``
with its custom VJP).

``sfconv_freq`` launches ``csrc/sfconv_freq_fwd.cu`` for a CUDA tensor and
runs the plain version (``ops/sfconv_spatial.sfconv_freq_spatial``) with its
autograd for a CPU tensor. Unlike the TPU path there is no width gate: on the
card every SFConv frequency branch goes through K2, unless the model's
``v4_widths`` route sends it to K3 (``ops/sfconv_rowtiled.py``), and its
backward (:func:`sfconv_freq_bwd`) launches K2 on the gradient for x̄ and
``csrc/sfconv_freq_bwd.cu`` for the four weight sums.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from unidefense_torch.ops import _build
from unidefense_torch.ops.sfconv_spatial import (
    double_reversal, hilbert_row_matrix, sfconv_freq_blocks, sfconv_freq_spatial, split_blocks)

MAX_WIDTH = 128  # the kernels keep up to 128 pixel rows (K2) or hm (both) in shared memory
SMEM_LIMIT = 232_448  # shared memory one block may use on an H100
GRID_YZ_LIMIT = 65_535  # largest y and z grid dimension
_MIX_ROWS = 128  # pixel rows of a mix tile: two consumer warpgroups of 64
_MIX_MAX_STAGES = 4
_PANEL = 64 * 128  # bytes of a 64-row x 64-column bf16 panel (rows of 128 bytes)
_SUM_TILE = 128  # A channels and G channels of a sums tile
_SUM_BK = 64  # pixel rows per sums ring stage
_SUM_STAGES = 4
_SUM_TARGET_BLOCKS = 2 * 132  # sums blocks to aim for: two waves of one block per SM
_SUM_MIN_PIXELS = 1024  # fewest pixel rows per split
_SUM_MAX_WORKSPACE = 64 * 2**20  # bytes of fp32 partial sums at most


@dataclasses.dataclass(frozen=True)
class MixGeometry:
    """Launch geometry of the bf16 channel mix on wgmma (``csrc/wgmma_mix.cuh``,
    384 threads: two consumer warpgroups and a producer warpgroup), shared by
    K2 (two A tiles a stage: the core and the mirror pixel), K3 (one) and K4
    (two: [x | hx] and [rx | hr])."""

    bn: int  # output channels per tile (64 or 128)
    stages: int  # ring depth
    rows: int  # R, image rows per tile (R * W <= 128), from the flattened (n, h) rows
    groups: int  # row groups, ceil(N * H / R)
    smem: int  # dynamic shared memory bytes
    grid: tuple  # (x, y, z)


A_TILES = {"K2": 2, "K3": 1, "K4": 2}  # A tiles a ring stage holds, per kernel


def mix_geometry(n: int, h: int, w: int, c: int, kernel: str = "K2") -> MixGeometry:
    """The tiles of ``kernel``'s bf16 mix for an (n, h, w, c) input: 128
    output channels, or 64 where 128 would pad more than a fifth of C (C =
    192); as many whole image rows as fit 128 pixel rows; as many stages as
    fit the shared memory, at most 4 (K2, K4: 3 at BN = 128, else 4). Raises
    ValueError if the row groups exceed the grid."""
    bn = 64 if (-c % 128) * 5 > c else 128
    stage = A_TILES[kernel] * _MIX_ROWS * 128 + 2 * (bn // 64) * _PANEL
    extra = 1024 + 2 * _MIX_ROWS * 4  # alignment, the pixel table; + 16 bytes of barriers a stage
    stages = min(_MIX_MAX_STAGES, (SMEM_LIMIT - extra) // (stage + 16))
    rows = _MIX_ROWS // w
    groups = -(-(n * h) // rows)
    if groups > GRID_YZ_LIMIT:
        raise ValueError(f"sfconv_freq: {n * h} image rows of width {w} need {groups} row groups, "
                         f"more than the grid's {GRID_YZ_LIMIT}")
    return MixGeometry(bn=bn, stages=stages, rows=rows, groups=groups,
                       smem=stages * (stage + 16) + extra, grid=(-(-c // bn), groups, 1))


def mix_tile_pixels(n: int, h: int, w: int, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(core, mirror): for every row group of the mix and each of its 128
    tile rows, the flat pixel index (n*H + h)*W + w of its core pixel and of
    its mirror pixel (n, (-h) mod H, (-w) mod W), or -1 where the producer
    zero-fills and the epilogue stores nothing. K2 loads its second operand
    at ``mirror``, so gathering x there gives double_reversal(x) at ``core``;
    K3 stores o2 at ``mirror``, so what lands in memory is R(o2)."""
    groups = -(-(n * h) // rows)
    t = torch.arange(_MIX_ROWS)
    ir = torch.arange(groups)[:, None] * rows + t // w
    wi = t % w
    valid = (t < rows * w) & (ir < n * h)
    ni, hi = ir // h, ir % h
    core = ir * w + wi
    mirror = (ni * h + (-hi) % h) * w + (-wi) % w
    return torch.where(valid, core, -1), torch.where(valid, mirror, -1)


@dataclasses.dataclass(frozen=True)
class SumsGeometry:
    """Launch geometry of the bf16 weight sums (``dw_wgmma_kernel``) of
    K2-bwd, K3-bwd and K4-bwd, 384 threads; the fp32 sums take the same
    splits."""

    tiles: int  # 128-channel tiles along each side of a C x C section
    splits: int  # ranges of whole image rows summed separately
    rows_per_split: int  # image rows per split (the last may hold fewer)
    workspace: int  # bytes of fp32 partial sums, 0 when splits == 1
    smem: int
    grid: tuple  # (G tiles, 2 section pairs x A tiles, splits)

    def ranges(self, img_rows: int) -> list[tuple[int, int]]:
        """[begin, end) image rows of every split, in order."""
        r = self.rows_per_split
        return [(z * r, min((z + 1) * r, img_rows)) for z in range(self.splits)]


def sums_geometry(n: int, h: int, w: int, c: int) -> SumsGeometry:
    """Tiles and splits of the weight sums for an (n, h, w, c) input: enough
    splits for about two waves of blocks, each split at least 1024 pixel rows
    and whole image rows, the workspace at most 64 MiB, no split empty."""
    tiles = -(-c // _SUM_TILE)
    img_rows = n * h
    per_split = 4 * c * c * 4
    splits = min(-(-_SUM_TARGET_BLOCKS // (2 * tiles * tiles)),
                 max(1, _SUM_MAX_WORKSPACE // per_split),
                 img_rows * w // _SUM_MIN_PIXELS, img_rows, GRID_YZ_LIMIT)
    splits = max(1, splits)
    rows_per_split = -(-img_rows // splits)
    splits = -(-img_rows // rows_per_split)
    return SumsGeometry(tiles=tiles, splits=splits, rows_per_split=rows_per_split,
                        workspace=splits * per_split if splits > 1 else 0,
                        smem=_SUM_STAGES * 3 * 2 * _PANEL + 1024 + 16 * _SUM_STAGES
                        + 4 * _SUM_BK * 4,
                        grid=(tiles, 2 * tiles, splits))


@functools.lru_cache(maxsize=None)  # one small matrix per (width, dtype, device)
def _device_hilbert(w: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # built once: a copy from pageable host memory on every call would block
    # the host until the card drains its queue, 24 times per UDEB4 forward
    return hilbert_row_matrix(w).to(device=device, dtype=dtype)


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (N, H, W, C) tensor")
    w, c = x.shape[2], x.shape[3]
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"{what} kernel supports 1 <= W <= {MAX_WIDTH}, got W={w}")
    if x.dtype == torch.bfloat16 and c % 8:
        raise ValueError(f"{what} kernel needs C % 8 == 0 for bfloat16, got C={c}")


def _mix_args(what: str, x: torch.Tensor, w_packed: torch.Tensor, part: str,
              kernel: str) -> tuple[int, int, int]:
    """(bn, rows, parts) that the C entry of a mix (``kernel``: K2, K3 or K4)
    takes for x and the packed (2C, 2C) kernel: the bf16 mix's tiles, or
    zeros for float32, which runs only whole (parts 3). Raises ValueError
    for a kernel of another shape or device, a part float32 cannot run, or
    more row groups than the grid takes."""
    n, h, w, c = x.shape
    if tuple(w_packed.shape) != (2 * c, 2 * c) or w_packed.device != x.device:
        raise ValueError(f"w_packed must be (2C, 2C) = {(2 * c, 2 * c)} on {x.device}")
    parts = {"hilbert": 1, "mix": 2, "both": 3}[part]
    if x.dtype != torch.bfloat16:
        if parts != 3:
            raise ValueError(f"{what}: only the bfloat16 path runs its kernels apart")
        return 0, 0, parts
    geo = mix_geometry(n, h, w, c, kernel)
    return geo.bn, geo.rows, parts


def _launch(x: torch.Tensor, w_packed: torch.Tensor, transposed: bool = False,
            part: str = "both", hx: torch.Tensor | None = None) -> torch.Tensor:
    """K2 on x with the blocks of the packed (2C, 2C) kernel: the forward, or
    with ``transposed`` x̄'s form (the forward's on g with (A1ᵀ, −A2ᵀ, B1ᵀ,
    B2ᵀ)). Three kernels: the block split (:func:`_split_blocks`), the
    Hilbert pass and the channel mix. For timing the last two apart (bf16
    only), part "hilbert" runs the Hilbert pass alone and returns hx, and
    part "mix" runs the mix alone on a given hx."""
    _check_input(x, "sfconv_freq")
    n, h, w, c = x.shape
    bn, rows, parts = _mix_args("sfconv_freq", x, w_packed, part, "K2")
    bf16 = x.dtype == torch.bfloat16
    if hx is not None:
        _check_operands("sfconv_freq", x, hx)
    elif bf16:
        hx = torch.empty_like(x)  # Hilbert products of the bf16 path
    # blocks split in fp32, then cast to the compute dtype (as the TPU kernel)
    blocks = _split_blocks(w_packed, c, x.dtype, transposed)
    hm = _device_hilbert(w, x.dtype, x.device)
    out = torch.empty_like(x) if part != "hilbert" else None
    fn = _build.function("sfconv_freq_fwd", "ud_sfconv_freq_fwd", 5, 8)
    err = fn(x.data_ptr(), blocks.data_ptr(), hm.data_ptr(), None if out is None else out.data_ptr(),
             None if hx is None else hx.data_ptr(), n, h, w, c, int(bf16), bn, rows, parts,
             _build.stream_ptr(x))
    _build.check(err, "sfconv_freq_fwd")
    sfconv_freq.launches += 1
    return hx if part == "hilbert" else out


def _split_blocks(w_packed: torch.Tensor, c: int, dtype: torch.dtype,
                  transposed: bool = False, negate_last: bool = False) -> torch.Tensor:
    """The (4, C, C) blocks the SFConv kernels add, contiguous in ``dtype``,
    split from the packed kernel on the card in one launch
    (``ud_sfconv_split_blocks``): the same values as :func:`_added_blocks`,
    rounded once to ``dtype``."""
    w = w_packed.float()
    blocks = torch.empty(4, c, c, dtype=dtype, device=w.device)
    fn = _build.function("sfconv_freq_fwd", "ud_sfconv_split_blocks", 2, 6)
    _build.check(fn(w.data_ptr(), blocks.data_ptr(), c, w.stride(0), w.stride(1),
                    int(transposed), int(negate_last), int(dtype == torch.bfloat16),
                    _build.stream_ptr(w)),
                 "sfconv_split_blocks")
    return blocks


def _added_blocks(w_packed: torch.Tensor, c: int, transposed: bool = False,
                  negate_last: bool = False) -> torch.Tensor:
    """Plain version of :func:`_split_blocks`: the (4, C, C) fp32 blocks the
    kernels add, split as ``split_blocks`` splits them (same rounding): (A1,
    −A2, B1, B2) for the forward of K2 and K3, (A1ᵀ, A2ᵀ, B1ᵀ, B2ᵀ) for
    their x̄ (the forward's form on g with (A1ᵀ, −A2ᵀ, B1ᵀ, B2ᵀ), its second
    block negated once more); with ``negate_last`` the fourth block negated,
    K4's (A1, −A2, B1, −B2) and (A1ᵀ, A2ᵀ, B1ᵀ, −B2ᵀ). A transposed result
    is a view."""
    w = w_packed.float()
    wrr, wri, wir, wii = w[:c, :c], w[:c, c:], w[c:, :c], w[c:, c:]
    last = -0.5 if negate_last else 0.5
    if transposed:
        blocks = torch.stack([wrr + wii, wri - wir, wrr - wii, wri + wir])
    else:
        blocks = torch.stack([wrr + wii, wir - wri, wrr - wii, wri + wir])
    blocks[:3].mul_(0.5)
    blocks[3].mul_(last)
    return blocks.transpose(1, 2) if transposed else blocks


def _check_operands(what: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    """x as every SFConv kernel takes it, each other tensor of x's shape,
    dtype and device, and all of them contiguous and 16-byte aligned."""
    _check_input(x, what)
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{what}: every operand must be a contiguous tensor of x's shape, "
                             "dtype and device")
    if any(t.data_ptr() % 16 for t in (x, *others)):
        raise ValueError(f"{what} reads 16 bytes at a time: its operands must be 16-byte aligned")


def _sums_scratch(x: torch.Tensor):
    """(splits, the (4C, C) fp32 sums, the (splits, 4C, C) fp32 workspace or
    None) of one weight-sum launch on x."""
    n, h, w, c = x.shape
    splits = sums_geometry(n, h, w, c).splits
    out = torch.empty(4 * c, c, dtype=torch.float32, device=x.device)
    ws = torch.empty(splits, 4 * c, c, dtype=torch.float32, device=x.device) if splits > 1 else None
    return splits, out, ws


def _launch_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2-bwd: (4C, C) fp32 sums [x | hx | R(x) | R(hx)]ᵀ g (A2's block not
    negated), hx = round(hm @ x) per image row."""
    _check_operands("sfconv_freq_bwd", x, g)
    n, h, w, c = x.shape
    splits, out, ws = _sums_scratch(x)
    hm = _device_hilbert(w, x.dtype, x.device)
    hx = torch.empty_like(x)
    fn = _build.function("sfconv_freq_bwd", "ud_sfconv_freq_bwd_dw", 6, 6)
    err = fn(x.data_ptr(), g.data_ptr(), hm.data_ptr(), hx.data_ptr(),
             None if ws is None else ws.data_ptr(), out.data_ptr(), n, h, w, c, splits,
             int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "sfconv_freq_bwd")
    sfconv_freq_bwd.launches += 1
    return out


def _repack(sums: torch.Tensor, c: int, dtype: torch.dtype) -> torch.Tensor:
    """(A1̄, −A2̄ as summed, B1̄, B2̄) stacked (4C, C) -> the (2C, 2C) gradient
    of the packed kernel (sfconv_pallas.py:285-289)."""
    a1b, a2b, b1b, b2b = sums[:c], -sums[c:2 * c], sums[2 * c:3 * c], sums[3 * c:]
    top = torch.cat([(a1b + b1b) * 0.5, (a2b + b2b) * 0.5], dim=1)
    bottom = torch.cat([(b2b - a2b) * 0.5, (a1b - b1b) * 0.5], dim=1)
    return torch.cat([top, bottom], dim=0).to(dtype)


def _transposed_blocks(w_packed: torch.Tensor, c: int) -> torch.Tensor:
    a1, a2, b1, b2 = split_blocks(w_packed, c)
    return torch.stack([a1.t(), -a2.t(), b1.t(), b2.t()])


def weight_sums_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K2-bwd: the (4C, C) fp32 sums [x | hx | R(x) |
    R(hx)]ᵀ g, hx rounded to x's dtype as the kernel rounds it."""
    c = x.shape[-1]
    hm = hilbert_row_matrix(x.shape[2]).to(device=x.device, dtype=x.dtype)
    hx = torch.einsum("dv,nhvc->nhdc", hm, x)
    a = torch.cat([x, hx, double_reversal(x), double_reversal(hx)], dim=-1).float()
    return a.reshape(-1, 4 * c).t() @ g.reshape(-1, c).float()


def sfconv_freq_bwd_plain(x: torch.Tensor, g: torch.Tensor, w_packed: torch.Tensor):
    """Plain version of the backward: (x̄, w̄) from the four sums and the
    repack, written out in torch. x̄ is the forward's form on g with the
    transposed blocks."""
    c = x.shape[-1]
    x_bar = sfconv_freq_blocks(g, *_transposed_blocks(w_packed, c))
    return x_bar, _repack(weight_sums_plain(x, g), c, w_packed.dtype)


def sfconv_freq_bwd(x: torch.Tensor, g: torch.Tensor, w_packed: torch.Tensor):
    """Backward of :func:`sfconv_freq`: (x̄, w̄) for x (N, H, W, C), the
    output gradient g and w_packed (2C, 2C). A CUDA tensor launches K2 for x̄
    and K2-bwd for the weight sums."""
    if not _build.uses_kernel(x):
        return sfconv_freq_bwd_plain(x, g, w_packed)
    c = x.shape[-1]
    x_bar = _launch(g, w_packed, transposed=True)
    return x_bar, _repack(_launch_dw(x, g), c, w_packed.dtype)


class _SFConvFreq(torch.autograd.Function):
    """Kernel forward; kernel backward (K2 on the gradient, then K2-bwd)."""

    @staticmethod
    def forward(ctx, x, w_packed):
        ctx.save_for_backward(x, w_packed)
        return _launch(x, w_packed)

    @staticmethod
    def backward(ctx, grad_out):
        x, w_packed = ctx.saved_tensors
        # autograd hands the gradient of a permuted view: make it NHWC-contiguous
        x_bar, w_bar = sfconv_freq_bwd(x, grad_out.to(x.dtype).contiguous(), w_packed)
        return x_bar, w_bar


def sfconv_freq(x_nhwc: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """SFConv frequency branch: (N, H, W, C) x (2C, 2C) -> (N, H, W, C) in
    x's dtype, equal to ``sfconv_freq_spatial``."""
    if not _build.uses_kernel(x_nhwc):
        return sfconv_freq_spatial(x_nhwc, w_packed)
    return _SFConvFreq.apply(x_nhwc, w_packed)


sfconv_freq.launches = 0  # K2 launches since the last reset (forwards and x̄)
sfconv_freq_bwd.launches = 0  # K2-bwd launches since the last reset
