"""``remat`` in the port (``layers.remat_call`` through
``torch.utils.checkpoint``) on the CPU: against JAX's ``nn.remat`` (a
ResNetStage, the b0 twin of UDEB4), against no remat with drop-connect on
(losses, gradients, running statistics, the generator), off outside
training, from a YAML through ``main``, and under the synced BatchNorm of
two gloo ranks."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_ranks
from tests.test_torch_models import B0_DELIMITER, _bridge, _init, _nchw, _nhwc, _randomise, _x
from tests.test_torch_resnet import _scaled
from unidefense_torch.data.transforms import DevicePipeline
from unidefense_torch.models import layers as tl
from unidefense_torch.models import resnet as tres
from unidefense_torch.models.convert import state_dict_from_jax
from unidefense_torch.models.registry import build_model
from unidefense_torch.train import optim as toptim
from unidefense_torch.train.step import create_train_state, make_train_step
from unidefense_tpu.models import resnet as jres
from unidefense_tpu.models.unidefense import UniDefenseModelEb4 as JaxUDEB4


@pytest.fixture(autouse=True)
def _keep_stdout(monkeypatch):
    # the engines tee stdout into their run directory
    monkeypatch.setattr(sys, "stdout", sys.stdout)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # engine steps beside the other test workers: more intra-op threads
    # only wait on each other
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ remat

def _stage(mod, remat):
    if mod is jres:
        return jres.ResNetStage(block_cls=jres.BasicBlock, planes=8, num_blocks=2, stride=1,
                                freq_norm="ortho", remat=remat)
    return tres.ResNetStage(tres.BasicBlock, 8, 8, 2, 1, True, remat=remat)


def _assert_grad_norms(ref: dict, got: dict, rel: float = 1e-3, floor: float = 1e-6,
                       sf_rel: float = 1e-2):
    """Per tensor |‖g_port‖ − ‖g_jax‖| <= rel ‖g_jax‖ + floor ‖all‖ (the
    floor: tensors whose gradient is rounding noise, tests/test_torch_train
    STEP_TOL[1]); ``sf_rel`` for the sf_coef scalars, whose gradient sums
    whole maps."""
    total = sum(float(g.norm()) ** 2 for g in ref.values()) ** 0.5
    for k, g in ref.items():
        nj, nt = float(g.norm()), float(got[k].grad.norm())
        bound = (sf_rel if k.endswith("sf_coef") else rel) * nj + floor * total
        assert abs(nt - nj) <= bound, f"{k}: |g| {nt} vs {nj} (all {total})"


def test_resnet_stage_remat_matches_jax():
    """A two-block ResNetStage with SFConvs in training, port with remat
    against JAX with ``nn.remat`` (tests/test_remat.py), on sum(out * r):
    the output within 1e-4 of max |ref|, the input gradient and every
    parameter's within 1e-4 of the tensor's max |ref|; the running
    statistics within 1e-5."""
    x = _x((2, 8, 8, 8))
    jm = _stage(jres, True)
    v = _scaled(_init(jm, jnp.asarray(x), True))
    r = _x((2, 8, 8, 8), 5)

    def loss(params, xx):
        out, mut = jm.apply({**v, "params": params}, xx, True, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, mut)

    (_, (jout, mut)), (jgp, jgx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    prefix, strip = ("extractor", "net", "layer2"), "extractor.layer2."
    tm = _stage(tres, True)
    tm.load_state_dict(_bridge(v, prefix, strip), strict=True)
    tm.train()
    xt = _nchw(x).requires_grad_(True)
    out = tm(xt)
    (out * _nchw(r)).sum().backward()
    for got, ref in ((_nhwc(out), jout), (_nhwc(xt.grad), jgx)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()))
    ref = _bridge({"params": jgp}, prefix, strip)
    got = dict(tm.named_parameters())
    assert set(ref) == set(got)
    for k, g in ref.items():
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * float(np.abs(g.numpy()).max()), err_msg=k)
    stats = _bridge({"batch_stats": mut["batch_stats"]}, prefix, strip)
    sd = tm.state_dict()
    for k, s in stats.items():
        if k.endswith("num_batches_tracked"):  # JAX keeps no count: once, not twice
            assert int(sd[k]) == 1, k
        else:
            np.testing.assert_allclose(sd[k].numpy(), s.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


def test_b0_udeb4_remat_matches_jax():
    """The b0 twin of UDEB4 at 32² in training (drop rates 0), port with
    remat against JAX with remat, on sum(cls_out²) + mean(rec²): the loss
    within rtol 1e-4, cls_out and rec within 2e-4 of their max |ref| (the
    random b0 twin's forward in training, with or without remat), every
    parameter's gradient by the norm as tests/test_torch_train's one-step
    bound (rel 1e-3, floor 1e-6 of the total; sf_coef rel 1e-2)."""
    jm = JaxUDEB4(extractor="efficientnet-b0", delimiter=B0_DELIMITER, drop_connect_rate=0.0,
                  feat_drop_rate=0.0, drop_rate=0.0, remat=True, dtype=jnp.float32)
    x = _x((4, 32, 32, 3))
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros(x.shape), train=False)
    v = _scaled(_randomise(v))

    def loss(params):
        out, _ = jm.apply({**v, "params": params}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(out["cls_out"] ** 2) + jnp.mean(out["rec"] ** 2), out

    (jl_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    tm = build_model("UDEB4", {"extractor": "efficientnet-b0", "delimiter": B0_DELIMITER,
                               "drop_connect_rate": 0.0, "feat_drop_rate": 0.0,
                               "drop_rate": 0.0}, remat=True)
    assert tm.backbone.remat
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    tm.train()
    out = tm(_nchw(x))
    tl_ = (out["cls_out"] ** 2).sum() + (out["rec"] ** 2).mean()
    tl_.backward()
    np.testing.assert_allclose(float(tl_.detach()), float(jl_), rtol=1e-4)
    for got, ref in ((out["cls_out"].detach().numpy(), jout["cls_out"]),
                     (_nhwc(out["rec"]), jout["rec"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * float(np.abs(ref).max()))
    got = {k: p for k, p in tm.named_parameters() if p.requires_grad}
    ref = state_dict_from_jax({"params": jg})
    _assert_grad_norms({k: g for k, g in ref.items() if k in got}, got)


def _counted_sfconvs(monkeypatch) -> list:
    """Counts the SFConv frequency branch's forwards (the recompute's too)."""
    calls = []
    plain = tl.sfconv_freq

    def counted(x, w):
        calls.append(tuple(x.shape))
        return plain(x, w)

    monkeypatch.setattr(tl, "sfconv_freq", counted)
    return calls


B0_REMAT = {"extractor": "efficientnet-b0", "delimiter": B0_DELIMITER, "drop_connect_rate": 0.5}


@pytest.mark.parametrize("name,cfg,size", [("UDR18", {}, 32), ("UDEB4", B0_REMAT, 64)],
                         ids=["UDR18", "UDEB4-b0"])
def test_remat_matches_no_remat(name, cfg, size, monkeypatch):
    """One two-pass step (sgd momentum) from the same weights and one
    generator seed, with and without remat, drop-connect 0.5 on the b0
    twin: losses and gradients within 1e-6 (fp32, CPU); running
    statistics and num_batches_tracked bit for bit; the generator's state
    equal after the step. The recompute ran: the frequency branch runs once
    more per pass for each SFConv of a rematerialised block, as many as
    chip_smoke.remat_sfconvs counts (its launch counts on the card)."""
    calls = _counted_sfconvs(monkeypatch)
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = build_model(name, cfg, remat=remat)
        tx, _ = toptim.build_optimizer({"optimizer": {"name": "sgd", "lr": 0.01,
                                                      "momentum": 0.9}})
        state = create_train_state(model, tx, device="cpu")
        step = make_train_step(tx, {}, 20, 2, 2, preprocess=DevicePipeline(hflip_p=0.5))
        frames = np.random.default_rng(7).integers(0, 256, (4, size, size, 3), dtype=np.uint8)
        gen = torch.Generator().manual_seed(3)
        del calls[:]
        _, metrics, _ = step(state, {"image": torch.from_numpy(frames),
                                     "label": torch.tensor([0, 0, 1, 1])}, gen)
        runs.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                         grads={n: p.grad.clone() for n, p in model.named_parameters()
                                if p.grad is not None},
                         state=model.state_dict(), gen=gen.get_state(), calls=len(calls),
                         recomputed=chip_smoke.remat_sfconvs(model)))
    plain, remat = runs
    assert plain["recomputed"] == 0 and remat["recomputed"] > 0
    assert remat["calls"] == plain["calls"] + 2 * remat["recomputed"]
    if name == "UDR18":  # the extractor's 6 of 8; the embedders' 2 are not rematerialised
        assert (plain["calls"], remat["recomputed"]) == (16, 6)
    for k, v in plain["metrics"].items():
        assert abs(remat["metrics"][k] - v) <= 1e-6, k
    assert plain["grads"].keys() == remat["grads"].keys()
    for k, g in plain["grads"].items():
        assert float((remat["grads"][k] - g).abs().max()) <= 1e-6, k
    for k, t in plain["state"].items():
        if k.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked"):
            assert torch.equal(remat["state"][k], t), k
    assert torch.equal(plain["gen"], remat["gen"])


def test_remat_is_off_outside_training():
    """Eval mode and no-grad forwards call the blocks plainly (no
    checkpoint): the Predictor's and the eval step's path does not change."""
    stage = _stage(tres, True).eval()
    x = _nchw(_x((2, 8, 8, 8)))
    with torch.no_grad():
        a = stage(x)
    stage.train()
    with torch.no_grad():
        b = stage(x)
    assert not tl.recomputing() and a.shape == b.shape
    stage.remat = False
    assert torch.equal(stage.eval()(x), a)


def test_remat_yaml_reaches_the_model_through_main(tmp_path, monkeypatch):
    """``config: remat: true`` in a model YAML builds the engine's model
    with every rematerialised container on (FE, UDR18 at 32², one step);
    without it, none."""
    import yaml

    from tests.test_torch_data import write_ffpp
    from tests.test_torch_multiproc import _argv, _fe_yml
    from unidefense_torch import main as tmain

    root = write_ffpp(tmp_path / "ffpp", videos=2, frames=2, size=(36, 36))
    monkeypatch.chdir(tmp_path)
    seen = {}
    for remat in (True, False):
        yml = _fe_yml(str(tmp_path), root, f"remat-{remat}", num_steps=1, num_devices=1)
        with open(yml) as f:
            cfg = yaml.safe_load(f)
        cfg["config"]["remat"] = remat
        with open(yml, "w") as f:
            yaml.safe_dump(cfg, f)
        engine = tmain.main(_argv(yml), device="cpu")
        stages = [m for m in engine.state.model.modules() if isinstance(m, tres.ResNetStage)]
        seen[remat] = [s.remat for s in stages]
        assert engine.state.step == 1
    assert seen[True] == [True] * 3 and seen[False] == [False] * 3


def test_remat_under_synced_batchnorm_matches_no_remat(tmp_path):
    """Two gloo ranks, UDR18 at 32² with synced BatchNorm, two two-pass
    steps on each rank's half with and without remat: every parameter and
    running statistic within 1e-6, num_batches_tracked equal, both ranks'
    states equal."""
    torch.manual_seed(0)
    weights = build_model("UDR18", {}).state_dict()
    rng = np.random.default_rng(11)
    halves = [rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8) for _ in range(2)]
    ranks = torch_ranks.spawn(torch_ranks.remat_steps, str(tmp_path), weights, halves)
    for rank in ranks:
        plain, remat = rank["plain"], rank["remat"]
        for k, t in plain.items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(remat[k], t), k
            else:
                assert float((remat[k] - t).abs().max()) <= 1e-6, k
    assert ranks[0]["digest"] == ranks[1]["digest"]
