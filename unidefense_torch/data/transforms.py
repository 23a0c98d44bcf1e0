"""Transforms (unidefense_tpu/data/transforms.py): the albumentations-style
YAML list, split into a host stage (decode, crop, resize to the fixed size)
and a device stage (K1: /255, mean/std and the horizontal flip on the whole
uint8 batch).

Ported: Resize, RandomResizedCrop (its box drawn here, the crop and the
bilinear or bicubic resize run in the host JPEG library), HorizontalFlip
and Normalize, the transforms of every config_template/forgery/data_*.yml
and ocim/data_*.yml. ImageCompression, the distorted OneOf and the device
corruptions (GaussianBlur, GaussNoise, RandomBrightnessContrast,
ColorJitter, OneOf) raise NotImplementedError (ROADMAP.md queue 3).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unidefense_torch.data.native import INTER_CUBIC, INTER_LINEAR
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


_MODES = {INTER_LINEAR: "bilinear", INTER_CUBIC: "bicubic"}


def resize_plain(frames_u8: np.ndarray, height: int, width: int,
                 interp: int = INTER_LINEAR) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, height, width, 3) uint8: bilinear or bicubic
    (A = -0.75, edges replicated) with half-pixel centres
    (align_corners=False), rounded and clamped. Within one intensity level
    of ``cv2.resize``'s INTER_LINEAR or INTER_CUBIC, with no cv2: the plain
    version of the host JPEG library's resize."""
    x = torch.from_numpy(np.ascontiguousarray(frames_u8)).permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(height, width), mode=_MODES[interp], align_corners=False)
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
    """The host stage (unidefense_tpu/data/transforms.py:153-290): the fixed
    output size and, for RandomResizedCrop (albumentations semantics), the
    area scale range, the aspect ratio range, the probability, cv2's
    interpolation code and the stream the boxes are drawn from. The port
    draws each box here, in the JAX package's order, and the datasets run
    the crop and the resize inside the host JPEG library's batched decode."""

    height: int = 256
    width: int = 256
    rrc_scale: Optional[tuple[float, float]] = None
    rrc_ratio: tuple = (0.75, 4.0 / 3.0)
    rrc_p: float = 1.0
    interpolation: int = INTER_LINEAR
    rng: Any = field(default_factory=lambda: LockedRNG(2022))

    def _random_resized_crop(self, h: int, w: int) -> tuple[int, int, int, int]:
        """(x, y, cw, ch) of the crop of an h x w frame: the draws of
        unidefense_tpu's ``_random_resized_crop``, then its centre-crop
        fallback after 10 tries."""
        area = h * w
        for _ in range(10):
            target_area = self.rng.uniform(*self.rrc_scale) * area
            log_ratio = (np.log(self.rrc_ratio[0]), np.log(self.rrc_ratio[1]))
            aspect = np.exp(self.rng.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                x = int(self.rng.integers(0, w - cw + 1))
                y = int(self.rng.integers(0, h - ch + 1))
                return x, y, cw, ch
        in_ratio = w / h
        if in_ratio < self.rrc_ratio[0]:
            cw, ch = w, int(round(w / self.rrc_ratio[0]))
        elif in_ratio > self.rrc_ratio[1]:
            cw, ch = int(round(h * self.rrc_ratio[1])), h
        else:
            cw, ch = w, h
        return (w - cw) // 2, (h - ch) // 2, cw, ch

    def crop_box(self, h: int, w: int) -> tuple[int, int, int, int]:
        """(x1, y1, x2, y2) within an h x w frame that the stage keeps: the
        RandomResizedCrop box when it applies (one ``rng.random()`` against
        p first, as the JAX stage draws), else the whole frame."""
        if self.rrc_scale is not None and self.rng.random() < self.rrc_p:
            x, y, cw, ch = self._random_resized_crop(h, w)
            return x, y, x + cw, y + ch
        return 0, 0, w, h


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
        elif name == "RandomResizedCrop":
            host.height = int(params["height"])
            host.width = int(params["width"])
            host.rrc_scale = tuple(params.get("scale", (0.08, 1.0)))
            host.rrc_ratio = tuple(params.get("ratio", (0.75, 4.0 / 3.0)))
            host.rrc_p = float(params.get("p", 1.0))
            host.interpolation = int(params.get("interpolation", INTER_LINEAR))
            if host.interpolation not in _MODES:
                raise NotImplementedError(
                    f"RandomResizedCrop interpolation {host.interpolation}: the port resizes "
                    f"with {INTER_LINEAR} (linear) or {INTER_CUBIC} (cubic)")
        elif name == "HorizontalFlip":
            dev_kwargs["hflip_p"] = float(params.get("p", 0.5))
        elif name == "Normalize":
            dev_kwargs["mean"] = tuple(params.get("mean", (0.5, 0.5, 0.5)))
            dev_kwargs["std"] = tuple(params.get("std", (0.5, 0.5, 0.5)))
        elif name in ("ImageCompression", "GaussianBlur", "GaussNoise",
                      "RandomBrightnessContrast", "ColorJitter", "OneOf"):
            raise NotImplementedError(f"Transform '{name}' {_QUEUE_3}")
        else:
            raise KeyError(f"Transform '{name}' not supported")
    return host, DevicePipeline(**dev_kwargs)
