"""The reference's weight files in and out of the port
(unidefense_torch/models/convert.py) against the JAX package's loaders and
export (unidefense_tpu/models/convert.py), on the CPU in fp32.

Every file is written here from seeded JAX variables by the JAX package's
own export (``save_torch_checkpoint``, ``export_torch_state_dict``), which
tests/test_convert.py pins as the exact inverse of its loaders. The JAX
loader and the port's read the same file into the same starting weights;
the port's ``state_dict()`` must then equal ``state_dict_from_jax`` of the
JAX result bit for bit (each BatchNorm's ``num_batches_tracked`` aside: the
JAX package counts no batches), and one eval forward of each format's load
must agree within the model tests' 1e-3. Models: UDEB4 on an efficientnet-b0 backbone
(the b0-scaled twin of test_torch_models) and UDR18, at 64x64."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import _engine, _keep_stdout, _one_thread, fe_config, ffpp  # noqa: F401
from tests.test_torch_models import B0_DELIMITER, _nchw, _nhwc, _randomise, _x
from tests.test_torch_resnet import _scaled
from tests.torch_tmp import drop_tmp_path  # noqa: F401 (autouse fixture)
from unidefense_torch.models import convert as tconv
from unidefense_torch.models.convert import state_dict_from_jax
from unidefense_torch.models.registry import build_model
from unidefense_tpu.models import convert as jconv
from unidefense_tpu.models.unidefense import UniDefenseModelEb4, UniDefenseModelRes18

ZERO_RATES = {"drop_rate": 0.0, "feat_drop_rate": 0.0}
# (JAX model, the port's model: YAML keys, the backbone's sub-tree and arch)
MODELS = {
    "UDEB4": (lambda: UniDefenseModelEb4(extractor="efficientnet-b0", delimiter=B0_DELIMITER,
                                         drop_connect_rate=0.0, dtype=jnp.float32, **ZERO_RATES),
              dict(ZERO_RATES, extractor="efficientnet-b0", delimiter=B0_DELIMITER,
                   drop_connect_rate=0.0), "backbone", "efficientnet"),
    "UDR18": (lambda: UniDefenseModelRes18(dtype=jnp.float32, **ZERO_RATES), dict(ZERO_RATES),
              "extractor", "resnet"),
}
TOL = dict(rtol=1e-3, atol=1e-3)  # test_udr_model_matches_jax, test_predictor_matches_jax_*


class Pickled:
    """A pickled module: ``load_pretrained_extractor`` reads it through its
    ``state_dict()``."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def _variables(shapes, seed: int) -> dict:
    """Seeded numpy variables of the JAX tree ``shapes``: every kernel
    lecun-normal (flax's default init), small random biases, random
    BatchNorm statistics and scales (``_randomise``, ``_scaled``), every
    sf_coef 0. Drawn in numpy: a jitted JAX init of these models takes
    10-20 s to compile."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return np.ones(s.shape, np.float32) if path[-1].key in ("scale", "var") \
            else np.zeros(s.shape, np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return _scaled(_randomise({k: dict(v) for k, v in tree.items()}, seed=seed), seed=seed + 1)


@pytest.fixture(scope="module")
def models():
    """Per model: the JAX module, a template (the starting weights, every
    sf_coef -0.5 so a kept init shows), the weights written to files, and
    a jitted eval forward."""
    out = {}
    for name, (make, cfg, sub, arch) in MODELS.items():
        jm = make()
        shapes = jax.eval_shape(lambda jm=jm: jm.init({"params": jax.random.PRNGKey(0)},
                                                      jnp.zeros((1, 64, 64, 3)), train=False))
        template = jax.tree_util.tree_map_with_path(
            lambda p, v: np.full_like(v, -0.5) if p[-1].key == "sf_coef" else v,
            _variables(shapes, 0))
        apply = jax.jit(lambda v, x, jm=jm: jm.apply(v, x, train=False))
        out[name] = dict(name=name, jm=jm, cfg=cfg, sub=sub, arch=arch, template=template,
                         weights=_variables(shapes, 2), apply=apply)
    return out


def _port(m, variables=None):
    """The port's model, eval mode, holding ``variables`` (default: the
    template)."""
    tm = build_model(m["name"], m["cfg"])
    tm.load_state_dict(state_dict_from_jax(m["template"] if variables is None else variables),
                       strict=True)
    return tm.eval()


def _same(got: dict, ref: dict) -> None:
    """The same keys; every tensor but num_batches_tracked equal bit for bit."""
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _forward_agrees(m, variables, tm) -> None:
    x = _x((2, 64, 64, 3), 5)
    ref = m["apply"](variables, jnp.asarray(x))
    with torch.no_grad():
        out = tm(_nchw(x))
    np.testing.assert_allclose(out["cls_out"].numpy(), np.asarray(ref["cls_out"]), **TOL)
    np.testing.assert_allclose(_nhwc(out["rec"]), np.asarray(ref["rec"]), **TOL)


def _sub(variables, sub):
    return {c: variables[c][sub] for c in ("params", "batch_stats")}


def _published(m) -> dict:
    """The weights' backbone as its public source names it: lukemelas
    EfficientNet with its ``_fc`` head, or torchvision ResNet with its
    ``layer4`` and ``fc``; no SFConv-only tensors."""
    sd = jconv.export_torch_state_dict(_sub(m["weights"], m["sub"]), m["arch"])
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()
          if not any(s in k for s in tconv.SF_ONLY)}
    rng = np.random.default_rng(9)
    extra = ({"_fc.weight": (1000, 1280), "_fc.bias": (1000,)} if m["arch"] == "efficientnet"
             else {"layer4.0.conv1.weight": (512, 256, 3, 3), "layer4.0.bn1.running_mean": (512,),
                   "fc.weight": (1000, 512), "fc.bias": (1000,)})
    for k, shape in extra.items():
        sd[k] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return sd


@pytest.mark.parametrize("name,wrapped", [("UDEB4", True), ("UDR18", False)],
                         ids=["UDEB4-ckpt", "UDR18-bare"])
def test_unidefense_checkpoint_loads_as_jax(models, tmp_path, name, wrapped):
    """A reference checkpoint (``{'model': sd, 'step', 'best_*'}``, or the
    bare state_dict) written by the JAX package: the port's load equals the
    JAX load and the file, and one forward agrees."""
    m = models[name]
    path = str(tmp_path / "model.bin")
    if wrapped:
        jconv.save_torch_checkpoint(m["weights"], path, "unidefense", step=7,
                                    extra_meta={"best_auc": 0.75})
    else:
        torch.save(jconv.export_torch_state_dict(m["weights"], "unidefense"), path)
    ref = jconv.load_unidefense_checkpoint(copy.deepcopy(m["template"]), path)
    tm = _port(m)
    assert tconv.load_unidefense_checkpoint(tm, path) == []
    _same(tm.state_dict(), state_dict_from_jax(ref))
    _same(tm.state_dict(), state_dict_from_jax(m["weights"]))
    _forward_agrees(m, ref, tm)


@pytest.mark.parametrize("name", list(MODELS))
def test_checkpoint_without_sfconv_tensors_keeps_their_init(models, tmp_path, name):
    """Keys deleted from the file (the SFConv-only ones, and one BatchNorm's
    statistics) keep the model's values, in the port as in the JAX
    package."""
    m = models[name]
    payload = {"model": {k: torch.from_numpy(np.array(v)) for k, v in
                         jconv.export_torch_state_dict(m["weights"], "unidefense").items()}}
    gone = [k for k in payload["model"] if any(s in k for s in tconv.SF_ONLY)]
    gone += ["bottleneck.running_mean"]
    for k in gone:
        del payload["model"][k]
    path = str(tmp_path / "partial.bin")
    torch.save(payload, path)
    ref = jconv.load_unidefense_checkpoint(copy.deepcopy(m["template"]), path)
    tm, before = _port(m), _port(m).state_dict()
    assert tconv.load_unidefense_checkpoint(tm, path) == ["bottleneck.running_mean"]
    _same(tm.state_dict(), state_dict_from_jax(ref))
    assert any("sf_coef" in k for k in gone) and any("freq_conv" in k for k in gone)
    for k in gone:
        assert torch.equal(tm.state_dict()[k], before[k]), k


@pytest.mark.parametrize("form", ["dict", "module"])
@pytest.mark.parametrize("name", list(MODELS))
def test_backbone_loads_as_jax(models, tmp_path, name, form):
    """A published backbone (lukemelas EfficientNet naming with ``_fc``;
    torchvision ResNet naming with ``layer4`` and ``fc``), from the JAX
    package's export of the weights' backbone: the port's
    ``load_pretrained_extractor`` equals the JAX one; every backbone tensor
    equals the file's, the SFConv-only ones keep their init, the rest of
    the model is untouched; one forward agrees."""
    m = models[name]
    sd = _published(m)
    path = str(tmp_path / "backbone.pth")
    torch.save(sd if form == "dict" else Pickled(sd), path)
    ref = jconv.load_pretrained_extractor(copy.deepcopy(m["template"]), path, name)
    tm, before = _port(m), _port(m).state_dict()
    assert tconv.load_pretrained_extractor(tm, path, name) == []
    got = tm.state_dict()
    _same(got, state_dict_from_jax(ref))
    prefix = m["sub"] + "."
    head = ("_fc.", "fc.", "layer4.")
    for k, v in sd.items():
        if not k.startswith(head):
            assert torch.equal(got[prefix + k], v), k
    assert not any(k.startswith(prefix + h) for k in got for h in head)
    kept = [k for k in got if not k.startswith(prefix) or any(s in k for s in tconv.SF_ONLY)]
    assert any("sf_coef" in k and k.startswith(prefix) for k in kept)
    for k in kept:
        assert torch.equal(got[k], before[k]), k
    if form == "dict":
        _forward_agrees(m, ref, tm)


def test_one_element_tensor_loads_into_a_scalar(models, tmp_path):
    """A (1,) ``fuse_coef``/``sf_coef`` in the file loads into the 0-d
    parameter: torch's ``_load_from_state_dict`` legacy rule, the JAX
    loader's rule (convert.py:50-55)."""
    m = models["UDR18"]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          jconv.export_torch_state_dict(m["weights"], "unidefense").items()}
    scalars = [k for k, v in sd.items() if v.dim() == 0 and v.is_floating_point()]
    assert "fuse_coef" in scalars and any("sf_coef" in k for k in scalars)
    for i, k in enumerate(scalars):
        sd[k] = torch.tensor([0.125 * (i + 1)])
    path = str(tmp_path / "legacy.bin")
    torch.save({"model": sd}, path)
    tm = _port(m)
    tconv.load_unidefense_checkpoint(tm, path)
    ref = state_dict_from_jax(jconv.load_unidefense_checkpoint(copy.deepcopy(m["template"]), path))
    for i, k in enumerate(scalars):
        got = tm.state_dict()[k]
        assert got.shape == () and float(got) == 0.125 * (i + 1), k
        assert torch.equal(got, ref[k]), k


@pytest.mark.parametrize("arch", ["unidefense", "efficientnet", "resnet"])
def test_export_matches_jax(models, tmp_path, arch):
    """``export_state_dict``: JAX's key set, floats bit for bit and of its
    dtype, a ``num_batches_tracked`` per BatchNorm; the whole model's file
    read back by the JAX loader gives the weights."""
    name = "UDR18" if arch == "resnet" else "UDEB4" if arch == "efficientnet" else None
    for n in ([name] if name else list(MODELS)):
        m = models[n]
        tm = _port(m, m["weights"])
        got = tconv.export_state_dict(tm, arch)
        ref = jconv.export_torch_state_dict(
            m["weights"] if arch == "unidefense" else _sub(m["weights"], m["sub"]), arch)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].numpy().dtype == v.dtype, k
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        if arch == "unidefense":
            path = str(tmp_path / f"{n}.bin")
            tconv.save_torch_checkpoint(tm, path, step=3, extra_meta={"best_acc": 0.5})
            payload = torch.load(path, weights_only=False)
            assert payload["step"] == 3 and payload["best_acc"] == 0.5
            back = jconv.load_unidefense_checkpoint(copy.deepcopy(m["template"]), path)
            _same(state_dict_from_jax(back), state_dict_from_jax(m["weights"]))


def test_engine_loads_weight_files_as_jax(fe_config, models, tmp_path, capsys):
    """``extractor_weights`` and ``init_weights`` through the FE engine's
    ``_build_training`` (UDR18): the backbone file loads as the JAX
    package's ``load_pretrained_extractor`` loads it into the same starting
    weights, the full checkpoint then supersedes it (the JAX order), each
    with the JAX package's log line; a missing backbone file warns, a
    missing ``init_weights`` raises FileNotFoundError; a resume supersedes
    both."""
    m = models["UDR18"]
    backbone, full = str(tmp_path / "resnet18.pth"), str(tmp_path / "full.bin")
    torch.save(_published(m), backbone)
    jconv.save_torch_checkpoint(m["weights"], full)

    fresh = _engine(fe_config, id="fresh")
    assert "WARNING: extractor_weights 'ckpt/resnet18.pth' not found" in capsys.readouterr().out
    start = {k: v.numpy() for k, v in fresh.state.model.state_dict().items()}
    template = jconv.load_torch_backbone(copy.deepcopy(m["template"]), start, "unidefense")
    ref = jconv.load_pretrained_extractor(template, backbone, "UDR18")

    cfg = copy.deepcopy(fe_config)
    cfg["model"]["extractor_weights"] = backbone
    loaded = _engine(cfg, id="backbone")
    assert f"Loaded pretrained extractor weights from {backbone}." in capsys.readouterr().out
    _same(loaded.state.model.state_dict(), state_dict_from_jax(ref))

    both = _engine(cfg, id="both", init_weights=full)
    out = capsys.readouterr().out
    assert out.index("Loaded pretrained extractor") < out.index(
        f"Initialized full model weights from {full}.")
    _same(both.state.model.state_dict(), state_dict_from_jax(m["weights"]))
    with pytest.raises(FileNotFoundError, match="init_weights"):
        _engine(cfg, id="missing", init_weights=str(tmp_path / "none.bin"))

    # a checkpoint of the fresh weights, then a resumed engine told to warm
    # start from both files: the checkpoint wins
    fresh.ckpt.save(fresh.state, fresh._meta(2), best=False)
    resumed = _engine(cfg, id="fresh", init_weights=full, resume=True)
    assert "Resumed from step 2" in capsys.readouterr().out
    _same(resumed.state.model.state_dict(), fresh.state.model.state_dict())
    assert os.path.exists(os.path.join(resumed.run_dir, "ckpt", "latest"))
