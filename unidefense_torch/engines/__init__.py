"""Engine registry (unidefense_tpu/engines/__init__.py; the reference's
engine/__init__.py:6-14). The UniAttack engine is not ported yet
(ROADMAP.md queue 3)."""

from unidefense_torch.engines.base import AbstractEngine
from unidefense_torch.engines.forgery import ForgeryEngine
from unidefense_torch.engines.ocim import OCIMEngine

ENGINE = {
    "FE": ForgeryEngine,
    "OCIM": OCIMEngine,
}
_NOT_PORTED = ("UE",)


def get_engine(name: str = "FE"):
    if name in _NOT_PORTED:
        raise KeyError(f"Engine '{name}' is not ported to unidefense_torch yet "
                       "(ROADMAP.md queue 3)")
    if name not in ENGINE:
        raise KeyError(f"Engine '{name}' not found; available: {sorted(ENGINE)}")
    return ENGINE[name]


__all__ = ["AbstractEngine", "ForgeryEngine", "OCIMEngine", "ENGINE", "get_engine"]
