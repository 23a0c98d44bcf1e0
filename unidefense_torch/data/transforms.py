"""Transforms (unidefense_tpu/data/transforms.py): the albumentations-style
YAML list, split into a host stage (decode, crop, resize to the fixed size,
then the host corruptions) and a device stage (K1: /255, mean/std and the
horizontal flip on the whole uint8 batch).

Every name of config_template/*/data_*.yml: Resize, RandomResizedCrop (its
box drawn here, the crop and the bilinear or bicubic resize run in the host
JPEG library), HorizontalFlip, Normalize, ImageCompression (a JPEG round
trip through the host library), the UniAttack Protocol I distorted OneOf
(``corrupt_distorted``: JPEG 50-60, blur 9/11, noise, contrast or
saturation, one per frame, on the host) and the device corruptions
(GaussianBlur, GaussNoise, RandomBrightnessContrast, ColorJitter, OneOf:
a per-sample OneOf in plain torch ops, the route on which the JAX package
runs no Pallas kernel either).

The host stage draws every random parameter of a batch first, frame by
frame in the JAX stage's order (crop box, OneOf, ImageCompression), from
its one ``rng``; the library then decodes the batch in one call and
:meth:`HostPipeline.apply` runs the corruptions. Noise, contrast and
saturation are the JAX stage's numpy expressions, so equal bit for bit.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unidefense_torch.data.native import INTER_CUBIC, INTER_LINEAR, decode_batch, encode_jpeg
from unidefense_torch.ops.perturb import gaussian_blur
from unidefense_torch.ops.preprocess import normalize_flip

_RGB_W = np.array([0.299, 0.587, 0.114], dtype=np.float32)  # ITU-R 601 luma
# the device corruptions of the reference's OneOf lists (dataset/uniattack.py:90-107)
CORRUPTIONS = ("GaussianBlur", "GaussNoise", "RandomBrightnessContrast", "ColorJitter", "OneOf")


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
class CorruptDraws:
    """The draws of the device corruption OneOf for a batch of N frames
    (unidefense_tpu/data/transforms.py:111-151): ``branch`` (N,) int64 in
    0..3 (blur, noise, contrast, saturation), ``u`` (N,) fp32 in [0, 1) (the
    noise variance 10 + 10u, the factor 0.5 + u), ``k11`` (N,) bool (an
    11-tap blur, else 9) and ``noise`` (N, H, W, 3) fp32 standard normal."""

    branch: torch.Tensor
    u: torch.Tensor
    k11: torch.Tensor
    noise: torch.Tensor

    @classmethod
    def draw(cls, shape, generator: torch.Generator) -> "CorruptDraws":
        n, dev = shape[0], generator.device
        return cls(branch=torch.randint(0, 4, (n,), generator=generator, device=dev),
                   u=torch.rand(n, generator=generator, device=dev),
                   k11=torch.rand(n, generator=generator, device=dev) < 0.5,
                   noise=torch.randn(tuple(shape), generator=generator, device=dev))


def corrupt_oneof(x: torch.Tensor, draws: CorruptDraws) -> torch.Tensor:
    """One corruption per sample of an (N, H, W, 3) batch in [0, 1]
    (``_corrupt_oneof``): every variant is computed batch-wide and the
    sample's branch selects it. Contrast is multiply-only (albumentations'
    uint8 LUT), the noise sigma is on the 0..255 scale."""
    col = (-1, 1, 1, 1)
    dev = x.device
    branch, u = draws.branch.to(dev).view(col), draws.u.to(dev, torch.float32).view(col)
    blurred = torch.where(draws.k11.to(dev).view(col), gaussian_blur(x, 11), gaussian_blur(x, 9))
    noised = (x + torch.sqrt(10.0 + 10.0 * u) / 255.0 * draws.noise.to(dev)).clamp(0.0, 1.0)
    alpha = 0.5 + u
    contrast = (x * alpha).clamp(0.0, 1.0)
    gray = (x * torch.from_numpy(_RGB_W).to(dev)).sum(-1, keepdim=True)
    saturation = (alpha * x + (1 - alpha) * gray).clamp(0.0, 1.0)
    return torch.where(branch == 0, blurred, torch.where(
        branch == 1, noised, torch.where(branch == 2, contrast, saturation)))


@dataclass
class DevicePipeline:
    """uint8 NHWC batch -> normalised float NHWC batch
    (unidefense_tpu/data/transforms.py:70-108), the normalise(+flip) path:
    one K1 launch per batch on the card. With ``hflip_p > 0`` and a
    generator, sample n is mirrored along W with probability hflip_p; the
    mask is drawn here, from the explicit generator, and handed to K1. A
    ``flip_mask`` passed in is used instead of a draw.

    With ``corrupt`` (a device corruption in the YAML list) the batch takes
    the JAX stage's own other route, which runs no Pallas kernel there and
    no K1 here: /255, the corruption OneOf (:func:`corrupt_oneof`, its draws
    from the generator, or ``draws`` passed in), the flip, mean/std, in
    plain torch ops. Without a generator and draws no corruption is drawn,
    as the JAX stage skips it without a key."""

    mean: tuple = (0.5, 0.5, 0.5)
    std: tuple = (0.5, 0.5, 0.5)
    hflip_p: float = 0.0
    corrupt: bool = False
    out_dtype: torch.dtype = torch.float32

    def __call__(self, batch_u8: torch.Tensor, generator: Optional[torch.Generator] = None,
                 flip_mask: Optional[torch.Tensor] = None,
                 draws: Optional[CorruptDraws] = None) -> torch.Tensor:
        if batch_u8.dtype != torch.uint8:
            raise TypeError(f"DevicePipeline takes uint8 batches, got {batch_u8.dtype}")
        if self.corrupt and draws is None and generator is not None:
            draws = CorruptDraws.draw(batch_u8.shape, generator)
        flip = None if flip_mask is None else flip_mask.to(batch_u8.device)
        if flip is None and self.hflip_p > 0 and generator is not None:
            draw = torch.rand(batch_u8.shape[0], generator=generator, device=generator.device)
            flip = (draw < self.hflip_p).to(batch_u8.device)
        if not self.corrupt:
            return normalize_flip(batch_u8, flip, self.mean, self.std, self.out_dtype)
        x = batch_u8.float() / 255.0
        if draws is not None:
            x = corrupt_oneof(x, draws)
        if flip is not None:
            x = torch.where(flip.bool().view(-1, 1, 1, 1), x.flip(2), x)
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
        return ((x - mean) / std).to(self.out_dtype)


def blur_u8(frames: np.ndarray, ksize: int) -> np.ndarray:
    """The host counterpart of ``cv2.GaussianBlur(img, (k, k), 0)`` on
    (N, H, W, 3) uint8 frames: the device route's separable Gaussian
    (``ops/perturb.gaussian_blur``, cv2's sigma, BORDER_REFLECT_101) in fp32
    on the host, rounded. Within one level of cv2 5.0's fixed-point 8-bit
    blur."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).float()
    return gaussian_blur(x, ksize).round().clamp(0, 255).to(torch.uint8).contiguous().numpy()


@dataclass
class HostPipeline:
    """The host stage (unidefense_tpu/data/transforms.py:153-248): the fixed
    output size; for RandomResizedCrop (albumentations semantics) the area
    scale range, the aspect ratio range, the probability and cv2's
    interpolation code; ImageCompression's quality range and probability;
    the Protocol I distorted OneOf; and the stream every draw comes from.

    The datasets call :meth:`draw` for each frame in item order before the
    batch is decoded (the crop box, then the OneOf, then ImageCompression:
    the JAX stage's per-frame order, whose stream the port therefore draws
    value for value), the host JPEG library crops and resizes the batch in
    one call, and :meth:`apply` runs the drawn corruptions on the decoded
    frames."""

    height: int = 256
    width: int = 256
    jpeg_compress: Optional[tuple[int, int]] = None  # (q_lo, q_hi) with prob jpeg_p
    jpeg_p: float = 0.0
    # UniAttack Protocol I distorted test (dataset/uniattack.py:90-107):
    # exactly one of {JPEG 50-60, blur 9/11, noise var 10-20, contrast +-0.5,
    # saturation +-0.5} per frame, drawn uniformly
    distorted_oneof: bool = False
    rrc_scale: Optional[tuple[float, float]] = None
    rrc_ratio: tuple = (0.75, 4.0 / 3.0)
    rrc_p: float = 1.0
    interpolation: int = INTER_LINEAR
    rng: Any = field(default_factory=lambda: LockedRNG(2022))

    @property
    def is_plain_resize(self) -> bool:
        """True when the stage only resizes: it draws nothing."""
        return self.jpeg_compress is None and self.rrc_scale is None and not self.distorted_oneof

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

    def _draw_distorted(self) -> tuple:
        """(branch, parameter) of the distorted OneOf, the JAX stage's draws
        in its order: the branch among five, then the JPEG quality, the
        blur's size, the noise (drawn at the output size), the contrast
        factor or the saturation factor."""
        c = int(self.rng.integers(0, 5))
        if c == 0:  # ImageCompression(quality 50..60)
            return c, int(self.rng.integers(50, 61))
        if c == 1:  # GaussianBlur(blur_limit=(9, 11)): odd ksize 9 or 11
            return c, int(self.rng.choice([9, 11]))
        if c == 2:  # GaussNoise(var_limit=(10, 20))
            sigma = float(np.sqrt(self.rng.uniform(10.0, 20.0)))
            return c, self.rng.normal(0.0, sigma, (self.height, self.width, 3))
        if c == 3:  # RandomBrightnessContrast(contrast_limit=0.5)
            return c, 1.0 + float(self.rng.uniform(-0.5, 0.5))
        return c, float(self.rng.uniform(0.5, 1.5))  # ColorJitter(saturation=0.5)

    def draw(self, h: Optional[int] = None, w: Optional[int] = None) -> tuple:
        """Every draw of one frame, in the JAX stage's order: (box, oneof,
        quality). ``box`` is the crop box within the frame's h x w region
        (:meth:`crop_box`; None without a RandomResizedCrop, whose box is
        the only draw that needs the size), ``oneof`` the distorted OneOf's
        (branch, parameter) or None, ``quality`` ImageCompression's or
        None."""
        box = self.crop_box(h, w) if self.rrc_scale is not None else None
        oneof = self._draw_distorted() if self.distorted_oneof else None
        quality = None
        if self.jpeg_compress is not None and self.rng.random() < self.jpeg_p:
            quality = int(self.rng.integers(self.jpeg_compress[0], self.jpeg_compress[1] + 1))
        return box, oneof, quality

    @staticmethod
    def _round_trip(frames: np.ndarray, qualities: dict) -> None:
        """A JPEG round trip of frames[i] at qualities[i], in place: the host
        library's encoder (cv2.imencode's bytes on libjpeg), then one
        decode call for all of them."""
        if not qualities:
            return
        idx = list(qualities)
        blobs = [encode_jpeg(frames[i], q) for i, q in qualities.items()]
        frames[idx] = decode_batch(blobs, None, frames.shape[1], frames.shape[2])

    def apply(self, frames: np.ndarray, draws: list) -> np.ndarray:
        """Run the drawn corruptions on the decoded (N, H, W, 3) uint8 frames
        in place, frame i with ``draws[i]`` of :meth:`draw`: the OneOf, then
        ImageCompression. Noise, contrast and saturation are the JAX stage's
        numpy expressions; the blurs of one size are one torch call."""
        jpeg, blurs = {}, {}
        for i, (_, oneof, _) in enumerate(draws):
            if oneof is None:
                continue
            c, p = oneof
            if c == 0:
                jpeg[i] = p
            elif c == 1:
                blurs.setdefault(p, []).append(i)
            elif c == 2:
                frames[i] = np.clip(frames[i].astype(np.float32) + p, 0, 255).astype(np.uint8)
            elif c == 3:
                frames[i] = np.clip(frames[i].astype(np.float32) * p, 0, 255).astype(np.uint8)
            else:
                img = frames[i].astype(np.float32)
                gray = (img @ _RGB_W)[..., None]
                frames[i] = np.clip(img * p + gray * (1.0 - p), 0, 255).astype(np.uint8)
        for k, idx in blurs.items():
            frames[idx] = blur_u8(frames[idx], k)
        self._round_trip(frames, jpeg)
        self._round_trip(frames, {i: q for i, (_, _, q) in enumerate(draws) if q is not None})
        return frames


def build_transforms(cfg_list: list[dict], corrupt_distorted: bool = False):
    """Translate an albumentations-style YAML transform list (e.g.
    config_template/forgery/data_ffc23.yml:12-37) into (HostPipeline,
    DevicePipeline). ``corrupt_distorted`` (the UniAttack test split with
    ``distorted: true``) runs the whole OneOf, JPEG included, on the host
    per frame and leaves the device stage to normalise."""
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
        elif name == "ImageCompression":
            host.jpeg_compress = (int(params.get("quality_lower", 99)),
                                  int(params.get("quality_upper", 100)))
            host.jpeg_p = float(params.get("p", 0.5))
        elif name in CORRUPTIONS:
            dev_kwargs["corrupt"] = True
        else:
            raise KeyError(f"Transform '{name}' not supported")
    if corrupt_distorted:
        host.distorted_oneof = True
        dev_kwargs.pop("corrupt", None)
    return host, DevicePipeline(**dev_kwargs)
