"""Exact spatial-domain form of the SFConv frequency branch
(unidefense_tpu/ops/sfconv_spatial.py:60-114) — the plain version of the
CUDA kernel in ``ops/sfconv_cuda.py``.

``irfft2(unpack(pack(rfft2(x)) @ W))`` with a frequency-independent packed
channel mix W = [[Wrr, Wri], [Wir, Wii]] equals

    out = x@A1 − H(x)@A2 + x̃@B1 − H(x̃)@B2

with A1 = (Wrr+Wii)/2, A2 = (Wri−Wir)/2, B1 = (Wrr−Wii)/2, B2 = (Wri+Wir)/2,
x̃[h, w] = x[−h mod H, −w mod W] and H the circular row-Hilbert matmul along
the width (see the JAX module's docstring for the derivation).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _hilbert_np(w: int) -> np.ndarray:
    d = np.arange(w)
    ks = np.arange(1, (w + 1) // 2)  # 0 < k < W/2 (the Nyquist sine vanishes)
    s = (2.0 / w) * np.sin(2 * np.pi * np.outer(d, ks) / w).sum(axis=1)
    idx = (d[:, None] - d[None, :]) % w
    out = s[idx].astype(np.float32)
    out.setflags(write=False)
    return out


def hilbert_row_matrix(w: int) -> torch.Tensor:
    """M[d, v] with out[.., d] = Σ_v x[.., v] s(d − v): the (W, W) fp32
    circular row-Hilbert matrix."""
    return torch.from_numpy(_hilbert_np(w).copy())


def split_blocks(w_packed: torch.Tensor, c: int):
    """(2C, 2C) packed kernel -> (A1, A2, B1, B2), each (C, C), in fp32
    (unidefense_tpu/ops/sfconv_pallas.py:124-133)."""
    w = w_packed.float()
    wrr, wri = w[:c, :c], w[:c, c:]
    wir, wii = w[c:, :c], w[c:, c:]
    return (wrr + wii) * 0.5, (wri - wir) * 0.5, (wrr - wii) * 0.5, (wri + wir) * 0.5


def double_reversal(x: torch.Tensor) -> torch.Tensor:
    """x̃[n, h, w] = x[n, (−h) mod H, (−w) mod W]."""
    return torch.roll(x.flip(1, 2), shifts=(1, 1), dims=(1, 2))


def sfconv_freq_blocks(x: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor, b1: torch.Tensor,
                       b2: torch.Tensor) -> torch.Tensor:
    """x@A1 − H(x)@A2 + x̃@B1 − H(x̃)@B2 for four given (C, C) blocks, in x's
    dtype. With the transposed blocks (A1ᵀ, −A2ᵀ, B1ᵀ, B2ᵀ) it is the
    branch's input gradient (Hᵀ = −H, x̃ is its own transpose, H∘R = −R∘H)."""
    dt = x.dtype
    a1, a2, b1, b2 = (m.to(dt) for m in (a1, a2, b1, b2))
    hm = hilbert_row_matrix(x.shape[2]).to(device=x.device, dtype=dt)
    x_rev = double_reversal(x)
    hx = torch.einsum("dv,nhvc->nhdc", hm, x)
    hx_rev = torch.einsum("dv,nhvc->nhdc", hm, x_rev)
    return x @ a1 - hx @ a2 + x_rev @ b1 - hx_rev @ b2


def sfconv_freq_spatial(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """SFConv frequency branch in the "pair" form, computed in x's dtype.

    x: (N, H, W, C); w_packed: (2C, 2C), rows = packed input channels.
    Returns (N, H, W, C) == irfft2_packed(spectrum_channels(x) @ w_packed)."""
    return sfconv_freq_blocks(x, *split_blocks(w_packed, x.shape[-1]))
