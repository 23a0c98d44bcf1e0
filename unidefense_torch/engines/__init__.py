"""Engine registry (unidefense_tpu/engines/__init__.py; the reference's
engine/__init__.py:6-14). The OCIM and UniAttack engines are not ported
yet (ROADMAP.md queue 3)."""

from unidefense_torch.engines.base import AbstractEngine
from unidefense_torch.engines.forgery import ForgeryEngine

ENGINE = {
    "FE": ForgeryEngine,
}
_NOT_PORTED = ("OCIM", "UE")


def get_engine(name: str = "FE"):
    if name in _NOT_PORTED:
        raise KeyError(f"Engine '{name}' is not ported to unidefense_torch yet "
                       "(ROADMAP.md queue 3)")
    if name not in ENGINE:
        raise KeyError(f"Engine '{name}' not found; available: {sorted(ENGINE)}")
    return ENGINE[name]


__all__ = ["AbstractEngine", "ForgeryEngine", "ENGINE", "get_engine"]
