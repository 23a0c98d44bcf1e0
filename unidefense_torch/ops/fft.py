"""2-D real FFT helpers on NHWC tensors (unidefense_tpu/ops/fft.py).

The spectrum is packed as channel-concatenated (real ‖ imag) planes, the
reference's convention, so a frequency-domain 1x1 conv is a trailing-axis
matmul. Transforms run in fp32 with cuFFT / pocketfft directly; the JAX
package's DFT-as-matmul dispatch and hermitian-extension inverse are TPU
workarounds and have no counterpart here.
"""

from __future__ import annotations

import torch

_SPATIAL = (1, 2)


def spectrum_channels(x: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """rfft2 over the spatial axes + channel packing:
    (N, H, W, C) -> (N, H, W//2+1, 2C) fp32."""
    z = torch.fft.rfft2(x.float(), dim=_SPATIAL, norm=norm)
    return torch.cat([z.real, z.imag], dim=-1)


def irfft2_packed(r: torch.Tensor, s: tuple[int, int], norm: str = "ortho") -> torch.Tensor:
    """Inverse of :func:`spectrum_channels`: (N, H, Wf, 2C) -> (N, H, W, C)
    fp32 with spatial size ``s``."""
    c = r.shape[-1] // 2
    r = r.float()
    z = torch.complex(r[..., :c], r[..., c:])
    return torch.fft.irfft2(z, s=tuple(s), dim=_SPATIAL, norm=norm)


def abs_angle_packed(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(amplitude, unit_re, unit_im) of a packed spectrum: real arithmetic
    for torch.abs/torch.angle + exp(1j*angle), the amplitude floored at
    1e-20 in the division."""
    c = r.shape[-1] // 2
    re, im = r[..., :c], r[..., c:]
    amp = (re * re + im * im).sqrt()
    safe = amp.clamp(min=1e-20)
    return amp, re / safe, im / safe
