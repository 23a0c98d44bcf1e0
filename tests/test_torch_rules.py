"""Rules of the port: it imports nothing of JAX or the JAX package, its
entry points run on the card unless told otherwise, and its kernel wrappers
never fall back to the plain version for a tensor that is not on the CPU."""

import ast
import pathlib
import types

import numpy as np
import pytest
import torch

from unidefense_torch.inference import Predictor
from unidefense_torch.models.registry import build_model
from unidefense_torch.ops import _build
from unidefense_torch.ops import preprocess, sfconv_cuda, sfconv_rowtiled

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


def _launches():
    rt = sfconv_rowtiled
    return (preprocess.normalize_flip.launches, sfconv_cuda.sfconv_freq.launches,
            sfconv_cuda.sfconv_freq_bwd.launches, rt.sfconv_freq_v4.launches,
            rt.sfconv_freq_v4_bwd.launches, rt.sfconv_freq_v3.launches,
            rt.sfconv_freq_v3_bwd.launches)


def _k2_backward():
    """The autograd backward of K2, as autograd calls it after a kernel
    forward: it launches K2 on the gradient, then K2-bwd."""
    x, w = torch.randn(1, 4, 4, 8), torch.randn(16, 16)
    ctx = types.SimpleNamespace(saved_tensors=(x, w))
    return sfconv_cuda._SFConvFreq.backward(ctx, torch.randn(1, 4, 4, 8))


def _rowtiled_backward(fn):
    """The autograd backward of K3 or K4 after a kernel forward: it launches
    the forward kernel on the gradient, then the sums kernel."""
    def call():
        x, w = torch.randn(1, 4, 4, 8), torch.randn(16, 16)
        ctx = types.SimpleNamespace(saved_tensors=(x, w))
        return fn.backward(ctx, torch.randn(1, 4, 4, 8))
    return call


def _sums_only(launch, nstreams):
    """A sums kernel alone (K3-bwd or K4-bwd), past its forward kernel."""
    return lambda: launch(*(torch.randn(1, 4, 4, 8) for _ in range(nstreams)))


@pytest.mark.parametrize("call", [
    lambda: preprocess.normalize_flip(_u8()),
    lambda: sfconv_cuda.sfconv_freq(torch.randn(1, 4, 4, 2), torch.randn(4, 4)),
    _k2_backward,
    lambda: sfconv_rowtiled.sfconv_freq_v4(torch.randn(1, 4, 4, 2), torch.randn(4, 4)),
    _rowtiled_backward(sfconv_rowtiled._SFConvFreqV4),
    _sums_only(sfconv_rowtiled._launch_v4_dw, 2),
    lambda: sfconv_rowtiled.sfconv_freq_v3(torch.randn(1, 4, 4, 2), torch.randn(4, 4)),
    _rowtiled_backward(sfconv_rowtiled._SFConvFreqV3),
    _sums_only(sfconv_rowtiled._launch_v3_dw, 3),
], ids=["K1", "K2", "K2-bwd", "K3", "K3-bwd", "K3-bwd-sums", "K4", "K4-bwd", "K4-bwd-sums"])
def test_wrappers_raise_instead_of_falling_back(monkeypatch, call):
    """With the device check stubbed to say "kernel", a wrapper on a machine
    without a card or nvcc must raise, not return the plain result, and
    count no launch."""
    monkeypatch.setattr(_build, "uses_kernel", lambda t: True)
    before = _launches()
    with pytest.raises(RuntimeError):
        call()
    assert _launches() == before


def _too_many_row_groups():
    """A bf16 input whose 65,536 image rows of width 65 (one per mix tile)
    exceed the grid; allocated, never written."""
    return torch.empty(1, 65_536, 65, 8, dtype=torch.bfloat16)


def test_k2_rejects_bf16_widths_off_the_tensor_core_tiles(monkeypatch):
    """The bf16 kernel reads channels 8 at a time; any other width is refused
    before a build or a launch, and so is an input with more row groups than
    the mix's grid takes."""
    monkeypatch.setattr(_build, "uses_kernel", lambda t: True)
    x = torch.randn(1, 4, 4, 5).to(torch.bfloat16)
    with pytest.raises(ValueError, match="C % 8"):
        sfconv_cuda.sfconv_freq(x, torch.randn(10, 10))
    before = _launches()
    with pytest.raises(ValueError, match="row groups"):
        sfconv_cuda.sfconv_freq(_too_many_row_groups(), torch.randn(16, 16))
    assert _launches() == before


def test_wrappers_do_not_count_plain_calls():
    before = _launches()
    preprocess.normalize_flip(_u8())
    sfconv_cuda.sfconv_freq(torch.randn(1, 4, 4, 2), torch.randn(4, 4))
    sfconv_cuda.sfconv_freq_bwd(torch.randn(1, 4, 4, 2), torch.randn(1, 4, 4, 2), torch.randn(4, 4))
    for version in ("v4", "v3"):
        x, w = torch.randn(1, 4, 4, 2, requires_grad=True), torch.randn(4, 4)
        getattr(sfconv_rowtiled, f"sfconv_freq_{version}")(x, w).sum().backward()
        getattr(sfconv_rowtiled, f"sfconv_freq_{version}_bwd")(x.detach(), x.detach(), w)
    assert _launches() == before


def test_k2_bwd_rejects_what_it_cannot_take(monkeypatch):
    """K2-bwd's entry refuses bf16 widths off the 16-byte loads and widths
    past its shared-memory Hilbert matrix, and its x̄ launch an input with
    more row groups than K2's grid, before a build or a launch."""
    monkeypatch.setattr(_build, "uses_kernel", lambda t: True)
    x = torch.randn(1, 4, 4, 12).to(torch.bfloat16)
    with pytest.raises(ValueError, match="C % 8"):
        sfconv_cuda._launch_dw(x, x.clone())
    x = torch.randn(1, 2, 130, 2)
    with pytest.raises(ValueError, match="W <= 128"):
        sfconv_cuda._launch_dw(x, x.clone())
    # x_bar runs through K2, whose mix refuses more row groups than its grid
    x = _too_many_row_groups()
    with pytest.raises(ValueError, match="row groups"):
        sfconv_cuda.sfconv_freq_bwd(x, x, torch.randn(16, 16))


@pytest.mark.parametrize("launch,nstreams", [
    (lambda x: sfconv_rowtiled._launch_v4(x, torch.zeros(2 * x.shape[-1], 2 * x.shape[-1])), 1),
    (sfconv_rowtiled._launch_v4_dw, 2),
    (lambda x, rx: sfconv_rowtiled._launch_v3(x, rx, torch.zeros(2 * x.shape[-1],
                                                                 2 * x.shape[-1])), 2),
    (sfconv_rowtiled._launch_v3_dw, 3),
], ids=["K3", "K3-bwd", "K4", "K4-bwd"])
@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 4, 4, 12), torch.bfloat16, "C % 8"),
    ((1, 2, 130, 2), torch.float32, "W <= 128"),
], ids=["bf16-C12", "W130"])
def test_rowtiled_kernels_reject_what_they_cannot_take(monkeypatch, launch, nstreams, shape,
                                                       dtype, match):
    """K3, K3-bwd, K4 and K4-bwd refuse bf16 widths off the 16-byte loads and
    widths past the 128 pixel rows of a block, before a build or a launch."""
    monkeypatch.setattr(_build, "uses_kernel", lambda t: True)
    before = _launches()
    with pytest.raises(ValueError, match=match):
        launch(*(torch.randn(shape).to(dtype) for _ in range(nstreams)))
    assert _launches() == before


@pytest.mark.parametrize("launch,nstreams", [
    (lambda x: sfconv_rowtiled._launch_v4(x, torch.zeros(16, 16, dtype=x.dtype)), 1),
    (lambda x, rx: sfconv_rowtiled._launch_v3(x, rx, torch.zeros(16, 16, dtype=x.dtype)), 2),
    (lambda x, g: sfconv_rowtiled.sfconv_freq_v4_bwd(x, g, torch.zeros(16, 16)), 2),
    (lambda x, g: sfconv_rowtiled.sfconv_freq_v3_bwd(x, g, torch.zeros(16, 16)), 2),
], ids=["K3", "K4", "K3-x-bar", "K4-x-bar"])
def test_rowtiled_mix_refuses_more_row_groups_than_its_grid(monkeypatch, launch, nstreams):
    """K3's and K4's bf16 mix, forward and x̄, refuse an input with more row
    groups than the grid takes, before a build or a launch."""
    monkeypatch.setattr(_build, "uses_kernel", lambda t: True)
    before = _launches()
    x = _too_many_row_groups()
    with pytest.raises(ValueError, match="row groups"):
        launch(*(x for _ in range(nstreams)))
    assert _launches() == before


def test_k3_route_refuses_what_k3_does_not_take():
    """The model's route sends to K3 only a square input of a listed width
    that the K2 gate (W >= 80) does not take first."""
    widths = {48, 24, 95, 100}
    assert sfconv_rowtiled.uses_v4((2, 48, 48, 336), widths)
    assert not sfconv_rowtiled.uses_v4((2, 48, 24, 336), widths)  # H != W
    assert not sfconv_rowtiled.uses_v4((2, 24, 48, 336), widths)
    assert not sfconv_rowtiled.uses_v4((2, 32, 32, 336), widths)  # not listed
    assert not sfconv_rowtiled.uses_v4((2, 95, 95, 192), widths)  # K2's at W >= 80
    assert sfconv_rowtiled.uses_v4((2, 100, 100, 1100), widths)  # past K2's weight gate


def test_bench_sfconv_runs_on_the_cpu():
    """The per-op A/B tool at a tiny shape on the CPU: every column and the
    interleaved minima, through the plain versions, with no launch counted."""
    from unidefense_torch.tools import bench_sfconv

    before = _launches()
    rows = bench_sfconv.run(shapes=[(6, 6, 8)], n=2, iters=1, device="cpu")
    assert set(rows[(6, 6, 8)]) == {"plain", "v2", "v3", "v4"}
    assert all(v > 0 for v in rows[(6, 6, 8)].values())
    best = bench_sfconv.interleaved(shapes=[(6, 6, 8)], n=2, iters=1, rounds=2, device="cpu")
    assert set(best[(6, 6, 8)]) == {"plain", "v2", "v4"}
    assert _launches() == before
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_sfconv.run(shapes=[(6, 6, 8)], n=1, iters=1, device=None)


def test_train_forward_masks_repeat_with_the_generator_seed():
    """A train-mode forward with every drop rate > 0 draws its masks from
    the generator: the same seed gives the same output twice, another seed
    another output."""
    torch.manual_seed(0)
    model = build_model("UDEB4", {"extractor": "efficientnet-b0",
                                  "delimiter": [1, 3, 5, 8, 11, 15, 16], "drop_rate": 0.5,
                                  "feat_drop_rate": 0.5, "drop_connect_rate": 0.5}).train()
    x = torch.randn(4, 3, 32, 32).contiguous(memory_format=torch.channels_last)

    def run(seed):
        with torch.no_grad():
            out = model(x, generator=torch.Generator().manual_seed(seed))
        return torch.cat([out["cls_out"].flatten(), out["rec"].flatten(),
                          out["loss_dict"]["factorization"].flatten()])

    first, again, other = run(3), run(3), run(4)
    assert torch.equal(first, again)
    assert not torch.equal(first, other)
