"""Rules of the port: it imports nothing of JAX or the JAX package, its
entry points run on the card unless told otherwise, and its kernel wrappers
never fall back to the plain version for a tensor that is not on the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from unidefense_torch.inference import Predictor
from unidefense_torch.ops import _build
from unidefense_torch.ops import preprocess, sfconv_cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "unidefense_tpu")


def _port_files():
    return sorted((ROOT / "unidefense_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_predictor_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor("UDEB4", model_cfg={"extractor": "efficientnet-b0",
                                      "delimiter": [1, 3, 5, 8, 11, 15, 16]})


def test_dispatch_rule():
    assert _build.uses_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        _build.uses_kernel(torch.zeros(1, device="meta"))


def _u8():
    return torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8))


@pytest.mark.parametrize("call", [
    lambda: preprocess.normalize_flip(_u8()),
    lambda: sfconv_cuda.sfconv_freq(torch.randn(1, 4, 4, 2), torch.randn(4, 4)),
], ids=["K1", "K2"])
def test_wrappers_raise_instead_of_falling_back(monkeypatch, call):
    """With the device check stubbed to say "kernel", a wrapper on a machine
    without a card or nvcc must raise, not return the plain result."""
    monkeypatch.setattr(_build, "uses_kernel", lambda t: True)
    before = (preprocess.normalize_flip.launches, sfconv_cuda.sfconv_freq.launches)
    with pytest.raises(RuntimeError):
        call()
    assert (preprocess.normalize_flip.launches, sfconv_cuda.sfconv_freq.launches) == before


def test_k2_rejects_bf16_widths_off_the_tensor_core_tiles(monkeypatch):
    """The bf16 kernel reads channels 8 at a time; any other width is refused
    before a build or a launch."""
    monkeypatch.setattr(_build, "uses_kernel", lambda t: True)
    x = torch.randn(1, 4, 4, 5).to(torch.bfloat16)
    with pytest.raises(ValueError, match="C % 8"):
        sfconv_cuda.sfconv_freq(x, torch.randn(10, 10))


def test_wrappers_do_not_count_plain_calls():
    before = (preprocess.normalize_flip.launches, sfconv_cuda.sfconv_freq.launches)
    preprocess.normalize_flip(_u8())
    sfconv_cuda.sfconv_freq(torch.randn(1, 4, 4, 2), torch.randn(4, 4))
    assert (preprocess.normalize_flip.launches, sfconv_cuda.sfconv_freq.launches) == before


def test_kernel_backward_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="K2-bwd"):
        sfconv_cuda._SFConvFreq.backward(None, torch.zeros(1))
