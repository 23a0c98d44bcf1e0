"""Device stage of the input pipeline (unidefense_tpu/data/transforms.py:70-108),
the normalise(+flip) path: one K1 launch per uint8 batch on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from unidefense_torch.ops.preprocess import normalize_flip


@dataclass
class DevicePipeline:
    """uint8 NHWC batch -> normalised float NHWC batch. With ``hflip_p > 0``
    and a generator, sample n is mirrored along W with probability hflip_p;
    the mask is drawn here, from the explicit generator, and handed to K1.
    A ``flip_mask`` passed in is used instead of a draw."""

    mean: tuple = (0.5, 0.5, 0.5)
    std: tuple = (0.5, 0.5, 0.5)
    hflip_p: float = 0.0
    out_dtype: torch.dtype = torch.float32

    def __call__(self, batch_u8: torch.Tensor, generator: Optional[torch.Generator] = None,
                 flip_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if batch_u8.dtype != torch.uint8:
            raise TypeError(f"DevicePipeline takes uint8 batches, got {batch_u8.dtype}")
        flip = None if flip_mask is None else flip_mask.to(batch_u8.device)
        if flip is None and self.hflip_p > 0 and generator is not None:
            draw = torch.rand(batch_u8.shape[0], generator=generator, device=generator.device)
            flip = (draw < self.hflip_p).to(batch_u8.device)
        return normalize_flip(batch_u8, flip, self.mean, self.std, self.out_dtype)
