"""Resize / pooling on NHWC tensors (unidefense_tpu/ops/resize.py:67-110).

torch's own operators carry the reference semantics directly
(``F.interpolate(bilinear, align_corners=True)``, ``F.adaptive_avg_pool2d``,
``F.max_pool2d``), so the JAX package's separable interpolation matrices are
not needed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from unidefense_torch.device import nchw, nhwc


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC bilinear resize with align_corners=True."""
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = F.interpolate(nchw(x), size=(out_h, out_w), mode="bilinear", align_corners=True)
    return nhwc(y)


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC adaptive average pool (torch window rule)."""
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    return nhwc(F.adaptive_avg_pool2d(nchw(x), (out_h, out_w)))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NC spatial mean."""
    return x.mean(dim=(1, 2))


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC nearest resize, source index floor(dst * in/out) as
    ``F.interpolate(mode='nearest')`` picks it, from explicit index tables."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == (out_h, out_w):
        return x
    rows = np.floor(np.arange(out_h) * (h / out_h)).astype(np.int64)
    cols = np.floor(np.arange(out_w) * (w / out_w)).astype(np.int64)
    x = x.index_select(1, torch.from_numpy(rows).to(x.device))
    return x.index_select(2, torch.from_numpy(cols).to(x.device))


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """NHWC max pool with symmetric padding that never wins (torch
    nn.MaxPool2d, the JAX version's -inf padding)."""
    return nhwc(F.max_pool2d(nchw(x), kernel, stride, padding))
