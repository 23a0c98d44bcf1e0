"""Transforms (unidefense_tpu/data/transforms.py): the albumentations-style
YAML list, split into a host stage (decode, crop, resize to the fixed size)
and a device stage (K1: /255, mean/std and the horizontal flip on the whole
uint8 batch).

Ported: Resize, HorizontalFlip and Normalize, the transforms of every
config_template/forgery/data_*.yml. RandomResizedCrop, ImageCompression,
the distorted OneOf and the device corruptions (GaussianBlur, GaussNoise,
RandomBrightnessContrast, ColorJitter, OneOf) raise NotImplementedError
(ROADMAP.md queue 3).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from unidefense_torch.ops.preprocess import normalize_flip

_QUEUE_3 = "is not ported to unidefense_torch yet (ROADMAP.md queue 3)"


class LockedRNG:
    """Mutex-serialized np.random.Generator proxy
    (unidefense_tpu/data/transforms.py:37-68).

    The prefetcher's worker threads call load_item, and through it the
    margin draw, at once, but numpy bit generators are not thread-safe.
    Every draw here holds a lock, so the stream stays valid under
    concurrency and equals the bare Generator's when single-threaded."""

    def __init__(self, gen_or_seed=2022):
        self._gen = (
            gen_or_seed
            if isinstance(gen_or_seed, np.random.Generator)
            else np.random.default_rng(gen_or_seed)
        )
        self._lock = threading.Lock()

    def __getattr__(self, name):
        fn = getattr(self._gen, name)
        if not callable(fn):
            return fn

        def locked(*args, **kwargs):
            with self._lock:
                return fn(*args, **kwargs)

        return locked


def resize_bilinear(frames_u8: np.ndarray, height: int, width: int) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, height, width, 3) uint8: bilinear with
    half-pixel centres (align_corners=False), rounded and clamped. Within
    one intensity level of ``cv2.resize``'s INTER_LINEAR, with no cv2."""
    x = torch.from_numpy(np.ascontiguousarray(frames_u8)).permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False)
    return y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()


@dataclass
class DevicePipeline:
    """uint8 NHWC batch -> normalised float NHWC batch
    (unidefense_tpu/data/transforms.py:70-108), the normalise(+flip) path:
    one K1 launch per batch on the card. With ``hflip_p > 0`` and a
    generator, sample n is mirrored along W with probability hflip_p; the
    mask is drawn here, from the explicit generator, and handed to K1. A
    ``flip_mask`` passed in is used instead of a draw."""

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


@dataclass
class HostPipeline:
    """The host stage's fixed output size (unidefense_tpu/data/
    transforms.py:155-249). The port's stage is a plain resize after the
    crop, which the datasets run inside the host JPEG library's batched
    decode."""

    height: int = 256
    width: int = 256


def build_transforms(cfg_list: list[dict], corrupt_distorted: bool = False):
    """Translate an albumentations-style YAML transform list (e.g.
    config_template/forgery/data_ffc23.yml:12-37) into (HostPipeline,
    DevicePipeline)."""
    if corrupt_distorted:
        raise NotImplementedError(f"the distorted OneOf {_QUEUE_3}")
    host = HostPipeline()
    dev_kwargs: dict = {}
    for t in cfg_list or []:
        name = t["name"]
        params = t.get("params", {}) or {}
        if name == "Resize":
            host.height = int(params["height"])
            host.width = int(params["width"])
        elif name == "HorizontalFlip":
            dev_kwargs["hflip_p"] = float(params.get("p", 0.5))
        elif name == "Normalize":
            dev_kwargs["mean"] = tuple(params.get("mean", (0.5, 0.5, 0.5)))
            dev_kwargs["std"] = tuple(params.get("std", (0.5, 0.5, 0.5)))
        elif name in ("RandomResizedCrop", "ImageCompression", "GaussianBlur", "GaussNoise",
                      "RandomBrightnessContrast", "ColorJitter", "OneOf"):
            raise NotImplementedError(f"Transform '{name}' {_QUEUE_3}")
        else:
            raise KeyError(f"Transform '{name}' not supported")
    return host, DevicePipeline(**dev_kwargs)
