"""CORAL per-sample colour transfer (unidefense_tpu/ops/coral.py:17-84):
whiten the source's 3x3 channel covariance and re-colour with the
target's, batched over NHWC stacks with plain tensor ops.
"""

from __future__ import annotations

import torch

from unidefense_torch.ops.eig3 import sym_eig3x3


def _mat_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The reference's "matrix sqrt", U sqrt(D) U (not U sqrt(D) Uᵀ): its
    code unpacks ``torch.linalg.svd`` as (U, D, V) though the third output
    is Vh. Every reference training ran with it, so it is kept. It depends
    on the eigenvector signs; ``sym_eig3x3`` fixes them."""
    d, u = sym_eig3x3(x)
    return (u * d.clamp(min=0.0).sqrt()[..., None, :]) @ u


def _mat_inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Inverse of the quirky sqrt: (U sqrt(D) U)^-1 = Uᵀ D^-1/2 Uᵀ."""
    d, u = sym_eig3x3(x)
    ut = u.transpose(-1, -2)
    return (ut * (1.0 / d.clamp(min=1e-12).sqrt())[..., None, :]) @ ut


def _flatten_mean_std(feat: torch.Tensor):
    """(N, H, W, 3) -> (N, 3, HW) channels with their mean and unbiased std."""
    f = feat.reshape(feat.shape[0], -1, feat.shape[-1]).transpose(1, 2)
    return f, f.mean(dim=-1, keepdim=True), f.std(dim=-1, keepdim=True)


def _cov(norm: torch.Tensor) -> torch.Tensor:
    """norm @ normᵀ + I, (N, 3, HW) -> (N, 3, 3) in norm's dtype, the
    products summed in float64. Summed in fp32, a product this long (K =
    H·W) comes out of cuBLAS about 1e2 further from the exact sum than on
    the CPU (6.0e-5 of its largest entry against 4.8e-7 at 256^2; NVIDIA
    H100 80GB HBM3, 700 W; ``tools/train_parity_probe``), and CORAL
    amplifies the error: its quirky sqrt depends on the eigenvectors, and
    noise-like images have eigenvalues within 2% of each other."""
    n = norm.double()
    eye = torch.eye(3, dtype=norm.dtype, device=norm.device)
    return (n @ n.transpose(1, 2)).to(norm.dtype) + eye


def coral(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CORAL transfer of each source image onto the colour statistics of
    the target image of the same index; NHWC, computed in fp32 (the
    covariances summed in float64), returned in source's dtype."""
    dtype = source.dtype
    sf, sm, ss = _flatten_mean_std(source.float())
    s_norm = (sf - sm) / ss
    s_cov = _cov(s_norm)
    tf, tm, ts = _flatten_mean_std(target.float())
    t_norm = (tf - tm) / ts
    t_cov = _cov(t_norm)
    transfer = _mat_sqrt(t_cov) @ (_mat_inv_sqrt(s_cov) @ s_norm)
    out = transfer * ts + tm
    return out.transpose(1, 2).reshape(source.shape).to(dtype)


def coral_single(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CORAL transfer for one HWC image pair."""
    return coral(source[None], target[None])[0]
