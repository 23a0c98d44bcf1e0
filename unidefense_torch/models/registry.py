"""Model registry (unidefense_tpu/models/registry.py:18-47)."""

from __future__ import annotations

import inspect
from typing import Iterable, Optional

import torch

from unidefense_torch.models.unidefense import (
    UniDefenseModelEb4, UniDefenseModelRes18, UniDefenseModelRes50)
from unidefense_torch.ops.sfconv_rowtiled import default_v4_widths

MODEL = {"UDEB4": UniDefenseModelEb4, "UDR18": UniDefenseModelRes18,
         "UDR50": UniDefenseModelRes50}

# Reference-style YAML `model:` keys passed through, each to the models whose
# constructor takes it (UDR has no drop_connect_rate or delimiter, UDEB4 no
# mid_depth). drop_connect_rate and feat_drop_rate must pass through:
# deterministic parity runs zero them (the JAX registry once dropped them
# silently). `delimiter` is additive and lets a narrower extractor (e.g.
# efficientnet-b0) serve as a small twin of UDEB4.
_KEYS = ("num_classes", "drop_rate", "extractor", "mid_depth", "freq_norm", "affine",
         "drop_connect_rate", "feat_drop_rate", "delimiter")


def load_model(name: str = "UDEB4"):
    key = name.upper()
    if key not in MODEL:
        raise KeyError(f"Model '{name}' not found; available: {sorted(MODEL)}")
    return MODEL[key]


def build_model(name: str, model_cfg: dict, dtype: Optional[torch.dtype] = None,
                v4_widths: Optional[Iterable[int]] = None, remat: bool = False):
    """Construct a model (fp32 params, on the CPU) from `model:` kwargs.
    ``v4_widths``: the SFConv widths routed to K3; None reads them from
    ``UD_SFCONV_V4``, here and nowhere else. ``remat``: the backbone's
    blocks rematerialised in training, for the models that take it (all
    three; registry.py:45-46)."""
    cls = load_model(name)
    takes = inspect.signature(cls).parameters
    kwargs = {k: model_cfg[k] for k in _KEYS if k in model_cfg and k in takes}
    if "bias" in model_cfg:
        kwargs["use_bias"] = model_cfg["bias"]
    if v4_widths is None:
        v4_widths = default_v4_widths()
    if remat and "remat" in takes:
        kwargs["remat"] = True
    return cls(dtype=dtype, v4_widths=v4_widths, **kwargs)
