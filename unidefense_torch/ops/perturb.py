"""Pixel-space input perturbations of training pass 2
(unidefense_tpu/ops/perturb.py:19-64): additive noise, a 5x5 gaussian blur
and a 0.75 nearest down-up-scale. NHWC. The noise is drawn by the caller.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from unidefense_torch.device import nchw, nhwc
from unidefense_torch.ops.resize import nearest_resize


def random_noise(x: torch.Tensor, normal: torch.Tensor, mean: float = 0.0,
                 std: float = 1e-4) -> torch.Tensor:
    """x + mean + std * normal, clipped to [-1, 1]; ``normal`` is a standard
    normal draw of x's shape."""
    return (x + (mean + std * normal.to(x.dtype))).clamp(-1.0, 1.0)


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_1d(kernel_size: int) -> tuple[float, ...]:
    """torchvision gaussian_blur's default sigma: 0.3*((k-1)*0.5 - 1) + 0.8."""
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    xs = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def gaussian_blur(x: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Separable gaussian blur with reflect padding (torchvision's), first
    along H, then along W, as weighted sums of shifted views, each pass
    accumulated into one buffer in place."""
    k = _gaussian_kernel_1d(kernel_size)
    pad = kernel_size // 2
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(nchw(x), (pad, pad, pad, pad), mode="reflect")
    y = xp[:, :, 0:h, :] * k[0]
    for i in range(1, kernel_size):
        y.add_(xp[:, :, i:i + h, :], alpha=k[i])
    out = y[:, :, :, 0:w] * k[0]
    for i in range(1, kernel_size):
        out.add_(y[:, :, :, i:i + w], alpha=k[i])
    return nhwc(out)


def downscale(x: torch.Tensor, bottleneck_scale: float = 0.75) -> torch.Tensor:
    """Nearest down-scale, then nearest up-scale back."""
    h, w = x.shape[1], x.shape[2]
    down = nearest_resize(x, int(math.floor(h * bottleneck_scale)),
                          int(math.floor(w * bottleneck_scale)))
    return nearest_resize(down, h, w)
