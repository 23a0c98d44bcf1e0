"""K2: SFConv frequency branch, forward, as a CUDA kernel
(unidefense_tpu/ops/sfconv_pallas.py:136-186, ``sfconv_freq_pallas``).

``sfconv_freq`` launches ``csrc/sfconv_freq_fwd.cu`` for a CUDA tensor and
runs the plain version (``ops/sfconv_spatial.sfconv_freq_spatial``) with its
autograd for a CPU tensor. Unlike the TPU path there is no width gate: on the
card every SFConv frequency branch goes through the kernel.
"""

from __future__ import annotations

import functools

import torch

from unidefense_torch.ops import _build
from unidefense_torch.ops.sfconv_spatial import hilbert_row_matrix, sfconv_freq_spatial, split_blocks

MAX_WIDTH = 128  # the kernel keeps up to 128 pixel rows of one block in shared memory


@functools.lru_cache(maxsize=None)  # one small matrix per (width, dtype, device)
def _device_hilbert(w: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # built once: a copy from pageable host memory on every call would block
    # the host until the card drains its queue, 24 times per UDEB4 forward
    return hilbert_row_matrix(w).to(device=device, dtype=dtype)


def _launch(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sfconv_freq takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (N, H, W, C) tensor")
    n, h, w, c = x.shape
    if tuple(w_packed.shape) != (2 * c, 2 * c) or w_packed.device != x.device:
        raise ValueError(f"w_packed must be (2C, 2C) = {(2 * c, 2 * c)} on {x.device}")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"sfconv_freq kernel supports 1 <= W <= {MAX_WIDTH}, got W={w}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and c % 8:
        raise ValueError(f"sfconv_freq kernel needs C % 8 == 0 for bfloat16, got C={c}")
    # blocks split in fp32, then cast to the compute dtype (as the TPU kernel)
    blocks = torch.stack(split_blocks(w_packed, c)).to(x.dtype).contiguous()
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


class _SFConvFreq(torch.autograd.Function):
    """Kernel forward; the backward kernel (K2-bwd) is not ported yet."""

    @staticmethod
    def forward(ctx, x, w_packed):
        return _launch(x, w_packed)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "sfconv_freq backward on CUDA needs the K2-bwd kernel, which is not "
            "ported yet (ROADMAP.md queue 2)"
        )


def sfconv_freq(x_nhwc: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """SFConv frequency branch: (N, H, W, C) x (2C, 2C) -> (N, H, W, C) in
    x's dtype, equal to ``sfconv_freq_spatial``."""
    if not _build.uses_kernel(x_nhwc):
        return sfconv_freq_spatial(x_nhwc, w_packed)
    return _SFConvFreq.apply(x_nhwc, w_packed)


sfconv_freq.launches = 0  # kernel launches since the last reset
