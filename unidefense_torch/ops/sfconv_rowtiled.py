"""K3, K3-bwd, K4 and K4-bwd: the row-tiled SFConv frequency kernels
(unidefense_tpu/ops/sfconv_pallas.py:296-670) as CUDA kernels.

Both compute the same function as K2 (``ops/sfconv_cuda.sfconv_freq``),

    out = x@A1 − H(x)@A2 + R(x)@B1 − H(R(x))@B2,

with another dataflow, which is what the per-op A/B tool
(``unidefense_torch/tools/bench_sfconv.py``) compares:

* ``sfconv_freq_v4`` (K3, ``csrc/sfconv_v4.cu``), the split-output form
  ``[x@A1 − H(x)@A2] + R(x@B1 + H(x)@B2)``: the kernel reads x once, with no
  mirror rows, and writes o1 and R(o2) (o2 stored at the mirror pixel); the
  wrapper adds them. Its backward launches K3 on the gradient with the
  transposed blocks for x̄ and K3-bwd for the four weight sums, reading R(g)
  through an index map. The model reaches K3 through the ``UD_SFCONV_V4``
  route (:func:`uses_v4`).
* ``sfconv_freq_v3`` (K4, ``csrc/sfconv_v3.cu``), over a double reversal
  rx = R(x) that the wrapper materialises: x and rx are two aligned streams.
  Its backward launches K4 on (g, R(g)) for x̄ and K4-bwd for the sums. No
  model calls it, in the JAX package either: the A/B tool is its caller.

A CPU tensor takes the plain PyTorch version in this module, a CUDA tensor
the kernel, which raises if it cannot launch.
"""

from __future__ import annotations

import os
from typing import Iterable

import torch

from unidefense_torch.ops import _build
from unidefense_torch.ops.sfconv_cuda import (
    _check_operands, _device_hilbert, _mix_args, _repack, _split_blocks, _sums_scratch,
    _transposed_blocks)
from unidefense_torch.ops.sfconv_spatial import double_reversal, hilbert_row_matrix, split_blocks

V2_MIN_WIDTH = 80  # the JAX model's K2 gate, which takes precedence over the V4 route
V2_MAX_WEIGHT_BYTES = 8 * 1024 * 1024  # ... while the four bf16 C x C blocks stay under this


# ------------------------------------------------------------------ route

def parse_v4_widths(raw: str) -> frozenset:
    """``UD_SFCONV_V4`` syntax: comma-separated widths, e.g. "48,24"."""
    return frozenset(int(t) for t in raw.split(",") if t.strip())


def default_v4_widths() -> frozenset:
    """The widths routed to K3 when a model is given none: ``UD_SFCONV_V4``,
    the same variable and syntax as the JAX package's gate (empty: K2
    everywhere)."""
    return parse_v4_widths(os.environ.get("UD_SFCONV_V4", ""))


def uses_v4(shape, v4_widths: Iterable[int]) -> bool:
    """Whether the SFConv frequency branch of an (N, H, W, C) input runs K3:
    a square input whose width is listed, unless the K2 gate of the JAX model
    (W >= 80 and 8·C² bytes < 8 MiB) takes it first
    (unidefense_tpu/models/layers.py:247-253)."""
    _, h, w, c = shape
    if w >= V2_MIN_WIDTH and c * c * 4 * 2 < V2_MAX_WEIGHT_BYTES:
        return False
    return w in v4_widths and h == w


# ------------------------------------------------------- plain versions

def _hilbert(x: torch.Tensor) -> torch.Tensor:
    """hm @ x per image row, in x's dtype."""
    hm = hilbert_row_matrix(x.shape[2]).to(device=x.device, dtype=x.dtype)
    return torch.einsum("dv,nhvc->nhdc", hm, x)


def _blocks(w_packed: torch.Tensor) -> torch.Tensor:
    """(2C, 2C) -> the (4, C, C) blocks A1, A2, B1, B2, split in fp32."""
    return torch.stack(split_blocks(w_packed, w_packed.shape[0] // 2))


def split_output_plain(x: torch.Tensor, blocks: torch.Tensor):
    """Plain version of K3: (o1, R(o2)) with o1 = x@m1 − H(x)@m2 and
    o2 = x@m3 + H(x)@m4 for blocks (m1, m2, m3, m4), in x's dtype."""
    m1, m2, m3, m4 = blocks.to(x.dtype)
    hx = _hilbert(x)
    return x @ m1 - hx @ m2, double_reversal(x @ m3 + hx @ m4)


def sfconv_freq_v4_plain(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """The split-output form o1 + R(o2), in x's dtype."""
    o1, o2r = split_output_plain(x, _blocks(w_packed))
    return o1 + o2r


def v4_weight_sums_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K3-bwd's sums: (4C, C) fp32, [x | hx | x | hx]ᵀ
    [g | g | R(g) | R(g)] (A2's block not negated), hx rounded to x's dtype."""
    c = x.shape[-1]
    xf, hf, gf, rgf = (t.reshape(-1, c).float() for t in (x, _hilbert(x), g, double_reversal(g)))
    return torch.cat([xf.t() @ gf, hf.t() @ gf, xf.t() @ rgf, hf.t() @ rgf])


def sfconv_freq_v4_bwd_plain(x: torch.Tensor, g: torch.Tensor, w_packed: torch.Tensor):
    """Plain version of K3's backward: (x̄, w̄). x̄ = x1 + R(x2) is K3's form
    on g with the transposed blocks (A1ᵀ, −A2ᵀ, B1ᵀ, B2ᵀ)."""
    c = x.shape[-1]
    x1, x2r = split_output_plain(g, _transposed_blocks(w_packed, c))
    return x1 + x2r, _repack(v4_weight_sums_plain(x, g), c, w_packed.dtype)


def v3_blocks_plain(x: torch.Tensor, rx: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: x@m1 − H(x)@m2 + rx@m3 − H(rx)@m4, in x's dtype."""
    m1, m2, m3, m4 = blocks.to(x.dtype)
    return x @ m1 - _hilbert(x) @ m2 + rx @ m3 - _hilbert(rx) @ m4


def sfconv_freq_v3_plain(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    return v3_blocks_plain(x, double_reversal(x), _blocks(w_packed))


def v3_weight_sums_plain(x: torch.Tensor, rx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K4-bwd's sums: (4C, C) fp32, [x | hx | rx | h(rx)]ᵀ g
    (A2's and B2's blocks not negated)."""
    c = x.shape[-1]
    a = torch.cat([x, _hilbert(x), rx, _hilbert(rx)], dim=-1).float()
    return a.reshape(-1, 4 * c).t() @ g.reshape(-1, c).float()


def _repack_v3(sums: torch.Tensor, c: int, dtype: torch.dtype) -> torch.Tensor:
    # B2̄ = −Σ h(rx)ᵀ g: negate the fourth block, then the (2C, 2C) repack
    return _repack(torch.cat([sums[:3 * c], -sums[3 * c:]]), c, dtype)


def sfconv_freq_v3_bwd_plain(x: torch.Tensor, g: torch.Tensor, w_packed: torch.Tensor):
    """Plain version of K4's backward: (x̄, w̄). x̄ is K4's form on (g, R(g))
    with the transposed blocks."""
    c = x.shape[-1]
    x_bar = v3_blocks_plain(g, double_reversal(g), _transposed_blocks(w_packed, c))
    sums = v3_weight_sums_plain(x, double_reversal(x), g)
    return x_bar, _repack_v3(sums, c, w_packed.dtype)


# --------------------------------------------------------------- kernels

def _launch_v4(x: torch.Tensor, w_packed: torch.Tensor, transposed: bool = False,
               part: str = "both", hx: torch.Tensor | None = None):
    """K3: (o1, R(o2)) for x (N, H, W, C) and the blocks of the packed (2C,
    2C) kernel, every one added: the forward's (A1, −A2, B1, B2), or with
    ``transposed`` x̄'s (A1ᵀ, A2ᵀ, B1ᵀ, B2ᵀ). Three kernels: the block split,
    the Hilbert pass and the mix. For timing the last two apart (bf16 only),
    part "hilbert" runs the Hilbert pass alone and returns hx, and part "mix"
    runs the mix alone on a given hx."""
    _check_operands("sfconv_freq_v4", x, *([] if hx is None else [hx]))
    n, h, w, c = x.shape
    bn, rows, parts = _mix_args("sfconv_freq_v4", x, w_packed, part, "K3")
    hx = torch.empty_like(x) if hx is None else hx
    blocks = _split_blocks(w_packed, c, x.dtype, transposed)
    hm = _device_hilbert(w, x.dtype, x.device)
    o1, o2r = (torch.empty_like(x), torch.empty_like(x)) if part != "hilbert" else (None, None)
    fn = _build.function("sfconv_v4", "ud_sfconv_v4_fwd", 6, 8)
    err = fn(x.data_ptr(), blocks.data_ptr(), hm.data_ptr(), None if o1 is None else o1.data_ptr(),
             None if o2r is None else o2r.data_ptr(), hx.data_ptr(), n, h, w, c,
             int(x.dtype == torch.bfloat16), bn, rows, parts, _build.stream_ptr(x))
    _build.check(err, "sfconv_freq_v4")
    sfconv_freq_v4.launches += 1
    return hx if part == "hilbert" else (o1, o2r)


def _launch_v4_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K3-bwd's sums, (4C, C) fp32 as :func:`v4_weight_sums_plain`."""
    _check_operands("sfconv_freq_v4_bwd", x, g)
    n, h, w, c = x.shape
    splits, out, ws = _sums_scratch(x)
    hm = _device_hilbert(w, x.dtype, x.device)
    hx = torch.empty_like(x)
    fn = _build.function("sfconv_v4", "ud_sfconv_v4_bwd_dw", 6, 6)
    err = fn(x.data_ptr(), g.data_ptr(), hm.data_ptr(), hx.data_ptr(),
             None if ws is None else ws.data_ptr(), out.data_ptr(), n, h, w, c, splits,
             int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "sfconv_freq_v4_bwd")
    sfconv_freq_v4_bwd.launches += 1
    return out


def _launch_v3(x: torch.Tensor, rx: torch.Tensor, w_packed: torch.Tensor,
               transposed: bool = False, part: str = "both",
               hxr: tuple[torch.Tensor, torch.Tensor] | None = None):
    """K4: x@m1 + H(x)@m2 + rx@m3 + H(rx)@m4 for the blocks of the packed
    kernel, every one added: the forward's (A1, −A2, B1, −B2), or with
    ``transposed`` x̄'s (A1ᵀ, A2ᵀ, B1ᵀ, −B2ᵀ). part "hilbert" runs the two
    Hilbert passes alone and returns (hx, hr); part "mix" runs the mix alone
    on a given ``hxr`` (bf16 only)."""
    _check_operands("sfconv_freq_v3", x, rx, *(hxr or ()))
    n, h, w, c = x.shape
    bn, rows, parts = _mix_args("sfconv_freq_v3", x, w_packed, part, "K4")
    hx, hr = hxr or (torch.empty_like(x), torch.empty_like(x))
    blocks = _split_blocks(w_packed, c, x.dtype, transposed, negate_last=True)
    hm = _device_hilbert(w, x.dtype, x.device)
    out = torch.empty_like(x) if part != "hilbert" else None
    fn = _build.function("sfconv_v3", "ud_sfconv_v3_fwd", 7, 8)
    err = fn(x.data_ptr(), rx.data_ptr(), blocks.data_ptr(), hm.data_ptr(),
             None if out is None else out.data_ptr(), hx.data_ptr(), hr.data_ptr(), n, h, w, c,
             int(x.dtype == torch.bfloat16), bn, rows, parts, _build.stream_ptr(x))
    _build.check(err, "sfconv_freq_v3")
    sfconv_freq_v3.launches += 1
    return (hx, hr) if part == "hilbert" else out


def _launch_v3_dw(x: torch.Tensor, rx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K4-bwd's sums, (4C, C) fp32 as :func:`v3_weight_sums_plain`."""
    _check_operands("sfconv_freq_v3_bwd", x, rx, g)
    n, h, w, c = x.shape
    splits, out, ws = _sums_scratch(x)
    hm = _device_hilbert(w, x.dtype, x.device)
    hx, hr = torch.empty_like(x), torch.empty_like(x)
    fn = _build.function("sfconv_v3", "ud_sfconv_v3_bwd_dw", 8, 6)
    err = fn(x.data_ptr(), rx.data_ptr(), g.data_ptr(), hm.data_ptr(), hx.data_ptr(),
             hr.data_ptr(), None if ws is None else ws.data_ptr(), out.data_ptr(), n, h, w, c,
             splits, int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "sfconv_freq_v3_bwd")
    sfconv_freq_v3_bwd.launches += 1
    return out


def sfconv_freq_v4_bwd(x: torch.Tensor, g: torch.Tensor, w_packed: torch.Tensor):
    """Backward of :func:`sfconv_freq_v4`: (x̄, w̄). A CUDA tensor launches K3
    on g for x̄ and K3-bwd for the weight sums."""
    if not _build.uses_kernel(x):
        return sfconv_freq_v4_bwd_plain(x, g, w_packed)
    x1, x2r = _launch_v4(g, w_packed, transposed=True)
    return x1.add_(x2r), _repack(_launch_v4_dw(x, g), x.shape[-1], w_packed.dtype)


def sfconv_freq_v3_bwd(x: torch.Tensor, g: torch.Tensor, w_packed: torch.Tensor):
    """Backward of :func:`sfconv_freq_v3`: (x̄, w̄). A CUDA tensor launches K4
    on (g, R(g)) for x̄ and K4-bwd for the weight sums."""
    if not _build.uses_kernel(x):
        return sfconv_freq_v3_bwd_plain(x, g, w_packed)
    x_bar = _launch_v3(g, double_reversal(g).contiguous(), w_packed, transposed=True)
    sums = _launch_v3_dw(x, double_reversal(x).contiguous(), g)
    return x_bar, _repack_v3(sums, x.shape[-1], w_packed.dtype)


class _SFConvFreqV4(torch.autograd.Function):
    """K3 forward; K3 on the gradient and K3-bwd backward."""

    @staticmethod
    def forward(ctx, x, w_packed):
        ctx.save_for_backward(x, w_packed)
        o1, o2r = _launch_v4(x, w_packed)
        return o1.add_(o2r)  # o1 + R(o2), added in x's dtype

    @staticmethod
    def backward(ctx, grad_out):
        x, w_packed = ctx.saved_tensors
        # autograd hands the gradient of a permuted view: make it NHWC-contiguous
        return sfconv_freq_v4_bwd(x, grad_out.to(x.dtype).contiguous(), w_packed)


class _SFConvFreqV3(torch.autograd.Function):
    """K4 forward; K4 on the gradient and K4-bwd backward."""

    @staticmethod
    def forward(ctx, x, w_packed):
        ctx.save_for_backward(x, w_packed)
        return _launch_v3(x, double_reversal(x).contiguous(), w_packed)

    @staticmethod
    def backward(ctx, grad_out):
        x, w_packed = ctx.saved_tensors
        return sfconv_freq_v3_bwd(x, grad_out.to(x.dtype).contiguous(), w_packed)


def sfconv_freq_v4(x_nhwc: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """SFConv frequency branch in split-output form (K3): (N, H, W, C) x
    (2C, 2C) -> (N, H, W, C) in x's dtype (sfconv_freq_pallas_v4)."""
    if not _build.uses_kernel(x_nhwc):
        return sfconv_freq_v4_plain(x_nhwc, w_packed)
    return _SFConvFreqV4.apply(x_nhwc, w_packed)


def sfconv_freq_v3(x_nhwc: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """SFConv frequency branch over a materialised double reversal (K4):
    (N, H, W, C) x (2C, 2C) -> (N, H, W, C) in x's dtype
    (sfconv_freq_pallas_v3)."""
    if not _build.uses_kernel(x_nhwc):
        return sfconv_freq_v3_plain(x_nhwc, w_packed)
    return _SFConvFreqV3.apply(x_nhwc, w_packed)


sfconv_freq_v4.launches = 0  # K3 launches since the last reset (forwards and x̄)
sfconv_freq_v4_bwd.launches = 0  # K3-bwd launches since the last reset
sfconv_freq_v3.launches = 0  # K4 launches since the last reset (forwards and x̄)
sfconv_freq_v3_bwd.launches = 0  # K4-bwd launches since the last reset
