"""Model registry (unidefense_tpu/models/registry.py:18-47)."""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from unidefense_torch.models.unidefense import UniDefenseModelEb4
from unidefense_torch.ops.sfconv_rowtiled import default_v4_widths

MODEL = {"UDEB4": UniDefenseModelEb4}
_NOT_PORTED = {"UDR18": "ROADMAP.md queue 1, UDR18/UDR50",
               "UDR50": "ROADMAP.md queue 1, UDR18/UDR50"}

# Reference-style YAML `model:` keys passed through. drop_connect_rate and
# feat_drop_rate must pass through: deterministic parity runs zero them
# (the JAX registry once dropped them silently). `delimiter` is additive and
# lets a narrower extractor (e.g. efficientnet-b0) serve as a small twin.
_KEYS = ("num_classes", "drop_rate", "extractor", "freq_norm", "affine",
         "drop_connect_rate", "feat_drop_rate", "delimiter")


def load_model(name: str = "UDEB4"):
    key = name.upper()
    if key in _NOT_PORTED:
        raise KeyError(f"Model '{name}' is not ported to unidefense_torch yet ({_NOT_PORTED[key]})")
    if key not in MODEL:
        raise KeyError(f"Model '{name}' not found; available: {sorted(MODEL)}")
    return MODEL[key]


def build_model(name: str, model_cfg: dict, dtype: Optional[torch.dtype] = None,
                v4_widths: Optional[Iterable[int]] = None):
    """Construct a model (fp32 params, on the CPU) from `model:` kwargs.
    ``v4_widths``: the SFConv widths routed to K3; None reads them from
    ``UD_SFCONV_V4``, here and nowhere else."""
    cls = load_model(name)
    kwargs = {k: model_cfg[k] for k in _KEYS if k in model_cfg}
    if "bias" in model_cfg:
        kwargs["use_bias"] = model_cfg["bias"]
    if v4_widths is None:
        v4_widths = default_v4_widths()
    return cls(dtype=dtype, v4_widths=v4_widths, **kwargs)
