"""The input perturbation of training pass 2, its draws and the CORAL
colour transfer, copied from the port's ``train/perturb.py``,
``ops/perturb.py``, ``ops/coral.py``, ``ops/eig3.py``, ``ops/style.py``,
``ops/resize.nearest_resize`` and ``ops/fft.py`` as they stood when the
benchmark was made (plain tensor operations there already), so that the
reference perturbs as the program's configuration asks whatever the program
later does."""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.model import nchw, nhwc

_EPS = 1e-12
PIXEL_NOISE, PIXEL_BLUR, PIXEL_DOWNSCALE = 0, 1, 2


def spectrum_channels(x, norm="ortho"):
    z = torch.fft.rfft2(x.float(), dim=(1, 2), norm=norm)
    return torch.cat([z.real, z.imag], dim=-1)


def irfft2_packed(r, s, norm="ortho"):
    c = r.shape[-1] // 2
    r = r.float()
    return torch.fft.irfft2(torch.complex(r[..., :c], r[..., c:]), s=tuple(s), dim=(1, 2),
                            norm=norm)


def abs_angle_packed(r):
    c = r.shape[-1] // 2
    re, im = r[..., :c], r[..., c:]
    amp = (re * re + im * im).sqrt()
    safe = amp.clamp(min=1e-20)
    return amp, re / safe, im / safe


def nearest_resize(x, out_h, out_w):
    h, w = x.shape[1], x.shape[2]
    if (h, w) == (out_h, out_w):
        return x
    rows = np.floor(np.arange(out_h) * (h / out_h)).astype(np.int64)
    cols = np.floor(np.arange(out_w) * (w / out_w)).astype(np.int64)
    x = x.index_select(1, torch.from_numpy(rows).to(x.device))
    return x.index_select(2, torch.from_numpy(cols).to(x.device))

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

def _det3(a: torch.Tensor) -> torch.Tensor:
    """3x3 determinant, the closed form jnp.linalg.det uses for 3x3."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def sym_eig3x3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a: (..., 3, 3) symmetric -> (eigvals (..., 3) descending,
    eigvecs (..., 3, 3) with eigvecs[..., :, i] the i-th eigenvector)."""
    a = a.float()
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = a.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    a_q = a - q[..., None, None] * eye
    p2 = (a_q * a_q).sum(dim=(-2, -1)) / 6.0
    p = p2.clamp(min=_EPS).sqrt()
    b = a_q / p[..., None, None]
    r = (_det3(b) / 2.0).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    eigvals = torch.stack([e1, e2, e3], dim=-1)  # descending

    def eigvec(lam_j, lam_k):
        # Cayley-Hamilton: (A - λj I)(A - λk I) columns ∝ the remaining eigenvector
        m = (a - lam_j[..., None, None] * eye) @ (a - lam_k[..., None, None] * eye)
        best = (m * m).sum(dim=-2).argmax(dim=-1)  # the column of largest norm
        col = m.gather(-1, best[..., None, None].expand(*m.shape[:-1], 1))[..., 0]
        return col / (col * col).sum(dim=-1, keepdim=True).clamp(min=_EPS).sqrt()

    eigvecs = torch.stack([eigvec(e2, e3), eigvec(e1, e3), eigvec(e1, e2)], dim=-1)

    # canonical signs: the largest-|component| of each eigenvector positive
    comp = eigvecs.abs().argmax(dim=-2)
    lead = eigvecs.gather(-2, comp[..., None, :])[..., 0, :]
    sign = torch.sign(torch.where(lead == 0, torch.ones_like(lead), lead))
    eigvecs = eigvecs * sign[..., None, :]

    # degenerate case (p ≈ 0: A ≈ q I): the identity basis
    degen = (p2 < 1e-10)[..., None, None]
    return eigvals, torch.where(degen, eye, eigvecs)

def _mat_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The reference's "matrix sqrt", U sqrt(D) U (not U sqrt(D) Uᵀ): its
    code unpacks ``torch.linalg.svd`` as (U, D, V) though the third output
    is Vh. Every reference training ran with it, so it is kept. It depends
    on the eigenvector signs; ``sym_eig3x3`` fixes them."""
    d, u = sym_eig3x3(x)
    return (u * d.clamp(min=0.0).sqrt()[..., None, :]) @ u


def _mat_inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Inverse of the quirky sqrt: (U sqrt(D) U)^-1 = Uᵀ D^-1/2 Uᵀ."""
    d, u = sym_eig3x3(x)
    ut = u.transpose(-1, -2)
    return (ut * (1.0 / d.clamp(min=1e-12).sqrt())[..., None, :]) @ ut


def _flatten_mean_std(feat: torch.Tensor):
    """(N, H, W, 3) -> (N, 3, HW) channels with their mean and unbiased std."""
    f = feat.reshape(feat.shape[0], -1, feat.shape[-1]).transpose(1, 2)
    return f, f.mean(dim=-1, keepdim=True), f.std(dim=-1, keepdim=True)


def _cov(norm: torch.Tensor) -> torch.Tensor:
    """norm @ normᵀ + I, (N, 3, HW) -> (N, 3, 3) in norm's dtype, the
    products summed in float64. Summed in fp32, a product this long (K =
    H·W) comes out of cuBLAS about 1e2 further from the exact sum than on
    the CPU (6.0e-5 of its largest entry against 4.8e-7 at 256^2; NVIDIA
    H100 80GB HBM3, 700 W; ``tools/train_parity_probe``), and CORAL
    amplifies the error: its quirky sqrt depends on the eigenvectors, and
    noise-like images have eigenvalues within 2% of each other."""
    n = norm.double()
    eye = torch.eye(3, dtype=norm.dtype, device=norm.device)
    return (n @ n.transpose(1, 2)).to(norm.dtype) + eye


def coral(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CORAL transfer of each source image onto the colour statistics of
    the target image of the same index; NHWC, computed in fp32 (the
    covariances summed in float64), returned in source's dtype."""
    dtype = source.dtype
    sf, sm, ss = _flatten_mean_std(source.float())
    s_norm = (sf - sm) / ss
    s_cov = _cov(s_norm)
    tf, tm, ts = _flatten_mean_std(target.float())
    t_norm = (tf - tm) / ts
    t_cov = _cov(t_norm)
    transfer = _mat_sqrt(t_cov) @ (_mat_inv_sqrt(s_cov) @ s_norm)
    out = transfer * ts + tm
    return out.transpose(1, 2).reshape(source.shape).to(dtype)


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
                  freq_norm: str = "ortho", source: Optional[torch.Tensor] = None,
                  rows: Optional[slice] = None) -> torch.Tensor:
    """The perturbed batch, same shape as x (N, H, W, C), real first. In the
    2-D mode x holds ``rows`` of the global batch: ``sum_real``, ``sum_fake``
    and ``draws`` are the global batch's, the per-image draws are cut to
    ``rows`` and the style partners come from ``source``, the global batch
    gathered over 'data' (needed for the style mix only)."""
    d = draws if draws is not None else PerturbDraws.draw(generator, sum_real, sum_fake,
                                                          tuple(x.shape))
    source = x if source is None else source
    rows = slice(None) if rows is None else rows
    if d.style:
        dev = x.device
        partners = torch.cat([d.perm_real.to(dev), sum_real + d.perm_fake.to(dev)])
        x_s = source[partners[rows]]
        if preserve_color:
            x_s = coral(x_s, x)
        lmda = d.lmda.to(dev)[rows]
        if d.freq:
            return frequency_style_transfer(x, x_s, lmda, norm=freq_norm)
        return spatial_style_transfer(x, x_s, lmda)
    if d.pixel == PIXEL_NOISE:
        return random_noise(x, d.normal[rows].to(x.device))
    if d.pixel == PIXEL_BLUR:
        return gaussian_blur(x, 5)
    return downscale(x, 0.75)
