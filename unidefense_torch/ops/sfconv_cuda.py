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

import functools

import torch

from unidefense_torch.ops import _build
from unidefense_torch.ops.sfconv_spatial import (
    double_reversal, hilbert_row_matrix, sfconv_freq_blocks, sfconv_freq_spatial, split_blocks)

MAX_WIDTH = 128  # the kernels keep up to 128 pixel rows (K2) or hm (both) in shared memory
_DW_TILE = 64  # output tile of the weight-sum kernel, in channels
_DW_BLOCKS = 2048  # blocks the weight-sum kernel aims for when it splits the pixel rows
_DW_MIN_ROWS = 512  # fewest pixel rows per split


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


def _launch_blocks(x: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """K2 with the four (C, C) blocks given directly, stacked as (4, C, C)."""
    _check_input(x, "sfconv_freq")
    n, h, w, c = x.shape
    if tuple(blocks.shape) != (4, c, c) or blocks.device != x.device:
        raise ValueError(f"blocks must be (4, C, C) = {(4, c, c)} on {x.device}")
    bf16 = x.dtype == torch.bfloat16
    blocks = blocks.to(x.dtype).contiguous()
    hm = _device_hilbert(w, x.dtype, x.device)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if bf16 else None  # Hilbert products of the bf16 path
    fn = _build.function("sfconv_freq_fwd", "ud_sfconv_freq_fwd", 5, 5)
    err = fn(x.data_ptr(), blocks.data_ptr(), hm.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(), n, h, w, c, int(bf16),
             _build.stream_ptr(x))
    _build.check(err, "sfconv_freq_fwd")
    sfconv_freq.launches += 1
    return out


def _launch(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    c = x.shape[-1]
    if tuple(w_packed.shape) != (2 * c, 2 * c) or w_packed.device != x.device:
        raise ValueError(f"w_packed must be (2C, 2C) = {(2 * c, 2 * c)} on {x.device}")
    # blocks split in fp32, then cast to the compute dtype (as the TPU kernel)
    return _launch_blocks(x, torch.stack(split_blocks(w_packed, c)))


def _dw_splits(pixels: int, c: int) -> int:
    """How many pixel-row ranges the weight-sum kernel sums separately."""
    t = -(-c // _DW_TILE)
    tiles = 4 * t * t
    return max(1, min(-(-_DW_BLOCKS // tiles), -(-pixels // _DW_MIN_ROWS)))


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
    splits = _dw_splits(n * h * w, c)
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
    x_bar = _launch_blocks(g, _transposed_blocks(w_packed, c))
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
