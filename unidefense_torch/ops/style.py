"""Style-transfer input perturbations of training pass 2
(unidefense_tpu/ops/style.py:17-79). NHWC. The per-sample blend factor
λ ~ U[0.5, 1) is drawn by the caller: larger λ means less perturbation.
"""

from __future__ import annotations

import torch

from unidefense_torch.ops.fft import abs_angle_packed, irfft2_packed, spectrum_channels


def frequency_style_transfer(content: torch.Tensor, style: torch.Tensor, lmda: torch.Tensor,
                             norm: str = "ortho") -> torch.Tensor:
    """Mix the FFT amplitudes of content and style by λ (N,), keep the
    content's phase."""
    h, w = content.shape[1], content.shape[2]
    lm = lmda.float().view(-1, 1, 1, 1)
    amp_a, unit_re, unit_im = abs_angle_packed(spectrum_channels(content, norm))
    amp_b, _, _ = abs_angle_packed(spectrum_channels(style, norm))
    amp = lm * amp_a + (1.0 - lm) * amp_b
    mixed = torch.cat([amp * unit_re, amp * unit_im], dim=-1)
    return irfft2_packed(mixed, (h, w), norm).to(content.dtype)


def spatial_style_transfer(content: torch.Tensor, style: torch.Tensor,
                           lmda: torch.Tensor) -> torch.Tensor:
    """Sorted-value (histogram-matching) mix with a straight-through term:
    per sample and channel, the style's sorted values are placed in the
    content's rank order (one stable sort of the content, one sort of the
    style, one scatter), and the blend passes gradients to ``content``
    only. Ties among the content's values are ranked by position."""
    n, h, w, c = content.shape
    lm = lmda.to(content.dtype).view(-1, 1, 1)
    cf = content.permute(0, 3, 1, 2).reshape(n, c, h * w)
    sf = style.permute(0, 3, 1, 2).reshape(n, c, h * w)
    idx = torch.sort(cf, dim=2, stable=True).indices
    matched = torch.zeros_like(cf).scatter_(2, idx, torch.sort(sf, dim=2).values)
    transferred = cf + (1.0 - lm) * matched - (1.0 - lm) * cf.detach()
    return transferred.reshape(n, c, h, w).permute(0, 2, 3, 1)
