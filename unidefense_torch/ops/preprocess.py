"""K1: fused uint8 -> normalised float preprocessing with per-sample flip
(unidefense_tpu/ops/pallas_preprocess.py:29-77).

``normalize_flip`` launches ``csrc/normalize_flip.cu`` for a CUDA batch and
runs :func:`normalize_flip_plain` for a CPU batch. Both use the TPU kernel's
formula ``(u8 * (1/255) - mean) * inv_std`` with ``inv_std = 1/std`` in fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from unidefense_torch.ops import _build


def _mean_inv_std(mean: Sequence[float], std: Sequence[float]) -> tuple[torch.Tensor, torch.Tensor]:
    m = torch.tensor(mean, dtype=torch.float32)
    inv = 1.0 / torch.tensor(std, dtype=torch.float32)
    return m, inv


def _check(batch_u8: torch.Tensor, flip_mask: Optional[torch.Tensor], out_dtype) -> None:
    if batch_u8.dtype != torch.uint8 or batch_u8.dim() != 4 or batch_u8.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) uint8, got {tuple(batch_u8.shape)} {batch_u8.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if flip_mask is not None:
        if flip_mask.shape != (batch_u8.shape[0],) or flip_mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError("flip_mask must be a (N,) bool or uint8 tensor")
        if flip_mask.device != batch_u8.device:
            raise ValueError("flip_mask must lie on the batch's device")


def normalize_flip_plain(batch_u8: torch.Tensor, flip_mask: Optional[torch.Tensor] = None,
                         mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K1 (same formula, flip as a reversed view)."""
    _check(batch_u8, flip_mask, out_dtype)
    m, inv = (t.to(batch_u8.device) for t in _mean_inv_std(mean, std))
    x = batch_u8
    if flip_mask is not None:
        x = torch.where(flip_mask.bool().view(-1, 1, 1, 1), x.flip(2), x)
    y = (x.float() * (1.0 / 255.0) - m) * inv
    return y.to(out_dtype)


def normalize_flip(batch_u8: torch.Tensor, flip_mask: Optional[torch.Tensor] = None,
                   mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                   out_dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, H, W, 3) ``out_dtype``, sample n mirrored
    along W where ``flip_mask[n]``. CUDA tensors launch the kernel."""
    if not _build.uses_kernel(batch_u8):
        return normalize_flip_plain(batch_u8, flip_mask, mean, std, out_dtype)
    _check(batch_u8, flip_mask, out_dtype)
    if not batch_u8.is_contiguous():
        raise ValueError("batch_u8 must be contiguous NHWC")
    n, h, w, _ = batch_u8.shape
    fn = _build.function("normalize_flip", "ud_normalize_flip", 4, 4)
    out = torch.empty(batch_u8.shape, dtype=out_dtype, device=batch_u8.device)
    flip = None if flip_mask is None else flip_mask.to(torch.uint8).contiguous()
    m, inv = _mean_inv_std(mean, std)
    params = (ctypes.c_float * 6)(*m.tolist(), *inv.tolist())
    err = fn(batch_u8.data_ptr(), None if flip is None else flip.data_ptr(), out.data_ptr(),
             ctypes.addressof(params), n, h, w, int(out_dtype == torch.bfloat16),
             _build.stream_ptr(batch_u8))
    _build.check(err, "normalize_flip")
    normalize_flip.launches += 1
    return out


normalize_flip.launches = 0  # kernel launches since the last reset
