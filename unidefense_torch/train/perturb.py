"""Input perturbation of training pass 2 (unidefense_tpu/train/perturb.py:32-74).

With probability 1/2 a style-transfer mix with a batch-permuted partner
(the real and the fake groups permuted separately, CORAL colour
preservation, then a frequency-amplitude or a sorted-value spatial mix,
chosen evenly); otherwise one of additive noise (σ 1e-4), a 5x5 gaussian
blur or a 0.75 nearest down-up-scale. It is data augmentation only, so it
runs without autograd. Every random choice is a field of
:class:`PerturbDraws`, drawn from an explicit generator unless the caller
passes them in (the JAX package's threefry draws cannot be reproduced).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from unidefense_torch.ops.coral import coral
from unidefense_torch.ops.perturb import downscale, gaussian_blur, random_noise
from unidefense_torch.ops.style import frequency_style_transfer, spatial_style_transfer

PIXEL_NOISE, PIXEL_BLUR, PIXEL_DOWNSCALE = 0, 1, 2


@dataclass
class PerturbDraws:
    """The random choices of one :func:`perturb_input` call."""

    style: bool              # style mix (else a pixel perturbation)
    perm_real: torch.Tensor  # (sum_real,) partner order inside the reals
    perm_fake: torch.Tensor  # (sum_fake,) partner order inside the fakes
    freq: bool               # frequency mix (else the spatial mix)
    lmda: torch.Tensor       # (N,) blend factors in [0.5, 1)
    pixel: int               # PIXEL_NOISE, PIXEL_BLUR or PIXEL_DOWNSCALE
    normal: torch.Tensor     # standard normal of x's shape, for the noise

    @classmethod
    def draw(cls, generator: torch.Generator, sum_real: int, sum_fake: int,
             shape: tuple) -> "PerturbDraws":
        """Every field from ``generator``, on its device; the three choices
        are read back to the host once."""
        dev = generator.device
        style, freq, pixel = torch.rand(3, generator=generator, device=dev).tolist()
        return cls(
            style=style > 0.5,
            perm_real=torch.randperm(sum_real, generator=generator, device=dev),
            perm_fake=torch.randperm(sum_fake, generator=generator, device=dev),
            freq=freq < 0.5,
            lmda=torch.rand(shape[0], generator=generator, device=dev) / 2.0 + 0.5,
            pixel=min(int(pixel * 3), PIXEL_DOWNSCALE),
            normal=torch.randn(shape, generator=generator, device=dev),
        )


@torch.no_grad()
def perturb_input(x: torch.Tensor, sum_real: int, sum_fake: int,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[PerturbDraws] = None, preserve_color: bool = True,
                  freq_norm: str = "ortho") -> torch.Tensor:
    """The perturbed batch, same shape as x (N, H, W, C), real first."""
    d = draws if draws is not None else PerturbDraws.draw(generator, sum_real, sum_fake,
                                                          tuple(x.shape))
    if d.style:
        dev = x.device
        x_s = torch.cat([x[:sum_real][d.perm_real.to(dev)], x[sum_real:][d.perm_fake.to(dev)]])
        if preserve_color:
            x_s = coral(x_s, x)
        lmda = d.lmda.to(dev)
        if d.freq:
            return frequency_style_transfer(x, x_s, lmda, norm=freq_norm)
        return spatial_style_transfer(x, x_s, lmda)
    if d.pixel == PIXEL_NOISE:
        return random_noise(x, d.normal.to(x.device))
    if d.pixel == PIXEL_BLUR:
        return gaussian_blur(x, 5)
    return downscale(x, 0.75)
