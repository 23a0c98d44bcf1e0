"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; asking for
``cuda`` on a machine without one raises instead of quietly running on the
CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises RuntimeError for ``cuda`` without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "unidefense_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (free for a channels_last tensor)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (a contiguous NHWC tensor becomes channels_last)."""
    return x.permute(0, 3, 1, 2)


def optional_dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    """The JAX layers' ``dtype=None`` promotes against fp32 params: fp32."""
    return torch.float32 if dtype is None else dtype
