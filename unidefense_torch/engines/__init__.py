"""Engine registry (unidefense_tpu/engines/__init__.py; the reference's
engine/__init__.py:6-14): FE (face forgery on FF++), OCIM (cross-domain
face anti-spoofing) and UE (the UniAttack benchmark)."""

from unidefense_torch.engines.base import AbstractEngine
from unidefense_torch.engines.forgery import ForgeryEngine
from unidefense_torch.engines.ocim import OCIMEngine
from unidefense_torch.engines.uniattack import UniAttackEngine

ENGINE = {
    "FE": ForgeryEngine,
    "OCIM": OCIMEngine,
    "UE": UniAttackEngine,
}


def get_engine(name: str = "FE"):
    if name not in ENGINE:
        raise KeyError(f"Engine '{name}' not found; available: {sorted(ENGINE)}")
    return ENGINE[name]


__all__ = ["AbstractEngine", "ForgeryEngine", "OCIMEngine", "UniAttackEngine", "ENGINE",
           "get_engine"]
