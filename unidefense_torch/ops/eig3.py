"""Analytic symmetric 3x3 eigendecomposition, batched, in elementwise ops
(unidefense_tpu/ops/eig3.py:22-65, line for line).

Eigenvalues come from the trigonometric (Cardano) solution of the
characteristic cubic, eigenvectors from Cayley-Hamilton ((A-λ2 I)(A-λ3 I)
has columns parallel to v1). ``torch.linalg.eigh`` is not a substitute:
CORAL's "matrix sqrt" U·√D·U (``ops/coral.py``) depends on the eigenvector
signs, and only this canonical sign convention (largest component positive)
reproduces the JAX package's output.

Eigenvalues are returned in DESCENDING order (the SVD order the reference's
``_mat_sqrt`` was written against).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _det3(a: torch.Tensor) -> torch.Tensor:
    """3x3 determinant, the closed form jnp.linalg.det uses for 3x3."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def sym_eig3x3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a: (..., 3, 3) symmetric -> (eigvals (..., 3) descending,
    eigvecs (..., 3, 3) with eigvecs[..., :, i] the i-th eigenvector)."""
    a = a.float()
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = a.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    a_q = a - q[..., None, None] * eye
    p2 = (a_q * a_q).sum(dim=(-2, -1)) / 6.0
    p = p2.clamp(min=_EPS).sqrt()
    b = a_q / p[..., None, None]
    r = (_det3(b) / 2.0).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    eigvals = torch.stack([e1, e2, e3], dim=-1)  # descending

    def eigvec(lam_j, lam_k):
        # Cayley-Hamilton: (A - λj I)(A - λk I) columns ∝ the remaining eigenvector
        m = (a - lam_j[..., None, None] * eye) @ (a - lam_k[..., None, None] * eye)
        best = (m * m).sum(dim=-2).argmax(dim=-1)  # the column of largest norm
        col = m.gather(-1, best[..., None, None].expand(*m.shape[:-1], 1))[..., 0]
        return col / (col * col).sum(dim=-1, keepdim=True).clamp(min=_EPS).sqrt()

    eigvecs = torch.stack([eigvec(e2, e3), eigvec(e1, e3), eigvec(e1, e2)], dim=-1)

    # canonical signs: the largest-|component| of each eigenvector positive
    comp = eigvecs.abs().argmax(dim=-2)
    lead = eigvecs.gather(-2, comp[..., None, :])[..., 0, :]
    eigvecs = eigvecs * torch.sign(torch.where(lead == 0, torch.ones_like(lead), lead))[..., None, :]

    # degenerate case (p ≈ 0: A ≈ q I): the identity basis
    degen = (p2 < 1e-10)[..., None, None]
    return eigvals, torch.where(degen, eye, eigvecs)
