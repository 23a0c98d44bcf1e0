"""Dynamic filters and the dual-space attention fusion
(unidefense_tpu/models/filters.py:23-126). In training the filters'
``proj_norm`` BatchNorm uses batch statistics and the embedding added to
the fused output passes through dropout.

Module names follow the reference (``layer1.0`` conv, ``layer1.1`` norm,
``layer2.0`` mask conv; ``freq_filter``, ``spat_filter`` and ``fuse_coef``
directly on the model), so the attention's parameters live on whichever
module owns them and :func:`dual_space_attention` does the computation.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidefense_torch.device import nchw, nhwc, optional_dtype
from unidefense_torch.models.layers import BatchNorm, Conv, dropout
from unidefense_torch.ops.fft import irfft2_packed, spectrum_channels
from unidefense_torch.ops.resize import bilinear_resize


class DynamicFilter(nn.Module):
    """layer1: conv(C -> C, k) + BN + activation; layer2: 1x1 conv + sigmoid
    over [mean(proj), max(proj), diff]. Returns (mask, mask * x). NCHW."""

    def __init__(self, channels: int, diff_channels: int, kernel_size: int,
                 activation: Callable = F.relu, bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation = activation
        self.layer1 = nn.Sequential(
            Conv(channels, channels, kernel_size, 1, kernel_size // 2, bias=bias, dtype=dtype),
            BatchNorm(channels, dtype=dtype),
        )
        self.layer2 = nn.Sequential(Conv(2 + diff_channels, 1, 1, 1, 0, bias=bias, dtype=dtype))

    def forward(self, x: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
        proj = self.activation(self.layer1(x))
        pre_mask = torch.cat([
            proj.mean(dim=1, keepdim=True),
            proj.amax(dim=1, keepdim=True),
            diff.to(proj.dtype),
        ], dim=1)
        mask = torch.sigmoid(self.layer2(pre_mask))
        return mask, mask * x


def dual_space_attention(freq_filter: DynamicFilter, spat_filter: DynamicFilter,
                         fuse_coef: torch.Tensor, pred: torch.Tensor, x: torch.Tensor,
                         embedding: torch.Tensor, freq_norm: str = "ortho",
                         dtype: Optional[torch.dtype] = None, drop_rate: float = 0.0,
                         training: bool = False,
                         generator: Optional[torch.Generator] = None) -> dict:
    """Re-weight ``embedding`` (N, C, H, W) by frequency- and spatial-domain
    masks conditioned on the reconstruction error; in training the embedding
    added to the result passes through dropout at ``drop_rate``. ``pred``
    and ``x`` are NCHW images."""
    eh, ew = embedding.shape[2], embedding.shape[3]
    pred = bilinear_resize(nhwc(pred), eh, ew)
    x = bilinear_resize(nhwc(x), eh, ew)
    emb = nhwc(embedding)

    freq_diff = (spectrum_channels(pred, freq_norm) - spectrum_channels(x, freq_norm)).abs()
    emb_freq = spectrum_channels(emb, freq_norm).to(optional_dtype(dtype))
    freq_mask, freq_filtered = freq_filter(nchw(emb_freq), nchw(freq_diff))
    freq_filtered = irfft2_packed(nhwc(freq_filtered), (eh, ew), freq_norm).to(embedding.dtype)

    spat_mask, spat_filtered = spat_filter(embedding, nchw((pred - x).abs()))
    coef = torch.sigmoid(fuse_coef).to(embedding.dtype)
    out = (1.0 - coef) * spat_filtered + coef * nchw(freq_filtered)
    out = out + dropout(embedding, drop_rate, training, generator)
    return {"out": out, "freq_mask": freq_mask, "spat_mask": spat_mask}


class DualSpaceAttention(nn.Module):
    """The attention as a module of its own (the models hold its three
    parameters directly, as the reference does)."""

    def __init__(self, channels: int, activation: Callable = F.relu, bias: bool = False,
                 drop_rate: float = 0.2, freq_norm: str = "ortho",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.drop_rate = drop_rate
        self.freq_norm = freq_norm
        self.compute_dtype = dtype
        self.freq_filter = DynamicFilter(2 * channels, 6, 1, activation, bias, dtype)
        self.spat_filter = DynamicFilter(channels, 3, 3, activation, bias, dtype)
        self.fuse_coef = nn.Parameter(torch.tensor(0.0))

    def forward(self, pred, x, embedding, generator: Optional[torch.Generator] = None) -> dict:
        return dual_space_attention(self.freq_filter, self.spat_filter, self.fuse_coef,
                                    pred, x, embedding, self.freq_norm, self.compute_dtype,
                                    self.drop_rate, self.training, generator)
