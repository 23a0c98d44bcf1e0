"""The port's training slice (unidefense_torch/train, train-mode layers, the
SFConv backward) against the JAX package on the CPU in fp32.

The whole two-pass step runs on the b0 twin of UDEB4 (efficientnet-b0,
delimiter [1,3,5,8,11,15,16]) at 64², batch 2 real + 2 fake, from the same
bridged weights, with every drop rate 0 and the flip mask and perturbation
draws taken from the JAX step's own keys. Gradients are read on both sides
where the optimizer receives them."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.test_torch_models import B0_DELIMITER, _bridge, _init, _nchw, _nhwc, _randomise, _x
from tests.test_torch_perturb import _branch, jax_perturb_draws
from unidefense_torch.data.transforms import DevicePipeline
from unidefense_torch.models import layers as tl
from unidefense_torch.models.convert import state_dict_from_jax, torch_key
from unidefense_torch.models.registry import build_model
from unidefense_torch.ops.sfconv_cuda import sfconv_freq_bwd_plain
from unidefense_torch.train import optim as toptim
from unidefense_torch.train.step import (
    StepDraws, create_train_state, make_normal_train_step, make_train_step)
from unidefense_tpu.data.transforms import DevicePipeline as JaxDevicePipeline
from unidefense_tpu.models import layers as jl
from unidefense_tpu.models.unidefense import UniDefenseModelEb4 as JaxUDEB4
from unidefense_tpu.ops.sfconv_pallas import sfconv_freq_pallas
from unidefense_tpu.train import optim as joptim
from unidefense_tpu.train.step import TrainState as JaxTrainState
from unidefense_tpu.train.step import make_normal_train_step as jax_make_normal_train_step
from unidefense_tpu.train.step import make_train_step as jax_make_train_step

# config_template/forgery/model_udeb4.yml
CFG = {"optimizer": {"name": "adamw", "lr": 1e-4, "betas": [0.9, 0.999], "weight_decay": 5e-6,
                     "amsgrad": True},
       "scheduler": {"name": "StepLR", "step_size": 22500, "gamma": 0.5},
       "lambda_triplet": 0.1, "lambda_recons": 0.1, "lambda_freq": 1.0, "lambda_mask": 0.1,
       "lambda_fac": 0.1}
LR = CFG["optimizer"]["lr"]
N, SUM_REAL, SUM_FAKE = 4, 2, 2
NUM_STEPS = 20  # the KL switch: steps 1 and 2 use the sparsity loss, step 3 the KL


# ------------------------------------------------------------ BatchNorm

@pytest.mark.parametrize("ndim", [2, 4])
def test_batchnorm_train_matches_jax(ndim):
    """Train-mode output and both running statistics (momentum 0.01, eps
    1e-3, the EfficientNet setting), rtol = atol = 1e-5."""
    x = _x((6, 5) if ndim == 2 else (3, 6, 7, 5), 1) * 2.0 + 0.5
    jm = jl.BatchNorm(momentum=0.01, epsilon=1e-3)
    v = _init(jm, jnp.asarray(x), use_running_average=True)
    v["params"]["scale"], v["params"]["bias"] = _x((5,), 2), _x((5,), 3)
    jy, mutated = jm.apply(v, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    tm = tl.BatchNorm(5, eps=1e-3, momentum=0.01).train()
    tm.load_state_dict(_bridge(v, ("backbone", "bn0"), "backbone._bn0."), strict=True)
    xt = torch.from_numpy(x) if ndim == 2 else _nchw(x)
    ty = tm(xt)
    got = ty.detach().numpy() if ndim == 2 else _nhwc(ty)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jy), **tol)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(stats["var"]), **tol)
    assert int(tm.num_batches_tracked) == 1


# ------------------------------------------------------------ optimizer

def _param_module(seed=0):
    rng = np.random.default_rng(seed)
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)))
    m.bias = torch.nn.Parameter(torch.from_numpy(rng.standard_normal(4).astype(np.float32)))
    m.s = torch.nn.Parameter(torch.tensor(0.3))
    return m


# a falling second moment: amsgrad's maximum then decides the step size
GRAD_SCALES = (1.0, 1.0, 0.1, 0.01, 0.001)


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: np.asarray(GRAD_SCALES[step] * rng.standard_normal(s), dtype=np.float32)
            for k, s in (("w", (3, 4)), ("bias", (4,)), ("s", ()))}


@pytest.mark.parametrize("name,amsgrad", [("adamw", True), ("adamw", False), ("adam", True),
                                          ("adam", False)])
def test_optimizer_matches_optax(name, amsgrad):
    """Five updates on identical gradients whose second moment falls, with
    warm-up and StepLR in the schedule: params after every update, rtol
    1e-5 and atol 1e-7 (fp32, another operation order)."""
    cfg = {"optimizer": {"name": name, "lr": 1e-2, "weight_decay": 0.1, "amsgrad": amsgrad},
           "warmup_step": 1, "scheduler": {"name": "StepLR", "step_size": 1, "gamma": 0.5}}
    m = _param_module()
    jparams = {k: jnp.asarray(p.detach().numpy()) for k, p in m.named_parameters()}
    tx_j, _ = joptim.build_optimizer(cfg, jparams)
    js = tx_j.init(jparams)
    tx, _ = toptim.build_optimizer(cfg)
    ts = tx.init(m)
    for step in range(5):
        g = _grads(step)
        u, js = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, js, jparams)
        jparams = optax.apply_updates(jparams, u)
        for k, p in m.named_parameters():
            p.grad = torch.from_numpy(g[k])
        tx.update(m, ts)
        for k, p in m.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} after update {step + 1}")
    assert ts.count == 5


def test_torch_amsgrad_differs_on_a_falling_second_moment():
    """Why the port does not use torch.optim.AdamW(amsgrad=True): on the
    same gradients it leaves optax's trajectory."""
    sched = toptim.build_lr_schedule(1e-2)
    ours, theirs = _param_module(), _param_module()
    tx = toptim.Adam(sched, amsgrad=True)
    ts = tx.init(ours)
    opt = torch.optim.AdamW(theirs.parameters(), lr=1e-2, weight_decay=0.0, amsgrad=True)
    for step in range(5):
        g = _grads(step)
        for m in (ours, theirs):
            for k, p in m.named_parameters():
                p.grad = torch.from_numpy(g[k].copy())
        tx.update(ours, ts)
        opt.step()
    gap = max((a - b).abs().max().item() for a, b in zip(ours.parameters(), theirs.parameters()))
    assert gap > 1e-4


SCHEDULES = [
    ({"name": "StepLR", "step_size": 3, "gamma": 0.5}, 2),
    ({"name": "MultiStepLR", "milestones": [2, 5], "gamma": 0.1}, 0),
    ({"name": "ExponentialLR", "gamma": 0.9}, 1),
    ({"name": "CosineAnnealingLR", "T_max": 4, "eta_min": 1e-5}, 2),
    ({"name": "CosineAnnealingWarmRestarts", "T_0": 3}, 0),
    ({"name": "TimmStepLR", "decay_t": 2, "decay_rate": 0.3}, 1),
    ({"name": "ReduceLROnPlateau"}, 3),
    (None, 0),
]


@pytest.mark.parametrize("sched,warmup", SCHEDULES, ids=lambda v: str(v))
def test_schedule_matches_jax(sched, warmup):
    """lr(c) over the first 24 updates (12 train steps: the warm-up ramp
    and several step boundaries), rtol 1e-6 (JAX computes in fp32)."""
    jaxs = joptim.build_lr_schedule(1e-3, warmup, sched)
    ours = toptim.build_lr_schedule(1e-3, warmup, sched)
    for c in range(24):
        np.testing.assert_allclose(ours(c), float(jaxs(c)), rtol=1e-6, err_msg=f"count {c}")
    assert ours(0) == ours(1)  # both updates of a step share the lr


def test_unported_optimizers_and_plateau():
    """A name outside the eight raises as in JAX; ReduceLROnPlateau's factor
    follows JAX's step for step."""
    with pytest.raises(KeyError, match="not implemented"):
        toptim.get_optimizer("lamb", toptim.build_lr_schedule(0.1))
    with pytest.raises(KeyError, match="not implemented"):
        joptim.get_optimizer("lamb", joptim.build_lr_schedule(0.1))
    cfg = {"optimizer": {"lr": 1e-3}, "scheduler": {"name": "ReduceLROnPlateau", "patience": 1,
                                                    "factor": 0.5}}
    ours, theirs = toptim.build_plateau(cfg, "max"), joptim.build_plateau(cfg, "max")
    for metric in (0.5, 0.6, 0.6, 0.55, 0.59, 0.7, 0.69, 0.68, 0.1):
        assert ours.step(metric) == theirs.step(metric)
    assert ours.scale < 1.0


def _b0_variables():
    jm = JaxUDEB4(extractor="efficientnet-b0", delimiter=B0_DELIMITER, drop_connect_rate=0.0,
                  feat_drop_rate=0.0, drop_rate=0.0, dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((N, 64, 64, 3)), train=False)
    return jm, _randomise(v)


def _b0_model(variables, v4_widths=()):
    tm = build_model("UDEB4", {"extractor": "efficientnet-b0", "delimiter": B0_DELIMITER,
                               "drop_connect_rate": 0.0, "feat_drop_rate": 0.0, "drop_rate": 0.0},
                     v4_widths=v4_widths)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return tm


@pytest.fixture(scope="module")
def b0():
    """The JAX b0 twin and its randomised variables, built once per file."""
    return _b0_variables()


def test_no_decay_set_matches_wd_mask(b0):
    """The parameters that take weight decay: the port's rule against
    optim._wd_mask, through the key bridge. The frozen bottleneck bias is
    no JAX parameter and is not trained in the port."""
    _, v = b0
    mask = flatten_dict(joptim._wd_mask(v["params"]))
    jax_decayed = {torch_key(path) for path, on in mask.items() if on}
    model = _b0_model(v)
    ours = {n for n, p in model.named_parameters() if toptim.decays(n, p)}
    assert ours == jax_decayed
    assert not model.bottleneck.bias.requires_grad and "bottleneck.bias" not in ours


# ------------------------------------------------------- SFConv backward

@pytest.mark.parametrize("shape", [(2, 5, 7, 4), (1, 7, 9, 3), (2, 6, 5, 8), (1, 1, 3, 2)])
def test_sfconv_freq_bwd_plain_matches_jax_pallas_backward(shape):
    """x̄ and w̄ of the plain backward == the VJP of the Pallas kernel in
    interpret mode (the custom VJP with the fused backward kernel), odd
    and even H and W; every H includes h = 0, its own mirror row. rtol =
    atol = 1e-4."""
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    wp = rng.standard_normal((2 * c, 2 * c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: sfconv_freq_pallas(a, b, True), jnp.asarray(x), jnp.asarray(wp))
    jx, jw = vjp(jnp.asarray(g))
    tx, tw = sfconv_freq_bwd_plain(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(wp))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-4)
    assert tw.dtype == torch.float32 and tx.dtype == torch.float32


# ------------------------------------------------------------- the step

def _recorder():
    """An optax transform that passes gradients through and keeps the last
    two it saw (newest first) in its state."""
    def init(params):
        zeros = jax.tree.map(jnp.zeros_like, params)
        return (zeros, zeros)

    def update(updates, state, params=None):
        return updates, (updates, state[0])

    return optax.GradientTransformation(init, update)


class RecordingAdam(toptim.Adam):
    """The port's optimizer, keeping the gradients of its last two updates."""

    def update(self, model, state, lr_scale=None):
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}
        self.seen = (getattr(self, "seen", [])[-1:]) + [grads]
        super().update(model, state, lr_scale)


def _step_key(seed: int, branch: str) -> jax.Array:
    """The first key from PRNGKey(seed) on whose perturbation draws (the
    third of the step's four keys) the pass-2 input takes ``branch``."""
    for s in range(seed, seed + 200):
        key = jax.random.PRNGKey(s)
        if _branch(jax_perturb_draws(jax.random.split(key, 4)[2], (N, 64, 64, 3))) == branch:
            return key
    raise AssertionError(branch)


def _step_draws(key) -> StepDraws:
    """The flip mask and perturbation draws of the JAX step with ``key``."""
    _, _, kp, kpre = jax.random.split(key, 4)
    _, kf = jax.random.split(kpre)
    flip = np.array(jax.random.uniform(kf, (N, 1, 1, 1)) < 0.5).reshape(-1)
    return StepDraws(flip=torch.from_numpy(flip), perturb=jax_perturb_draws(kp, (N, 64, 64, 3)))


def _batch():
    frames = np.random.default_rng(7).integers(0, 256, (N, 64, 64, 3), dtype=np.uint8)
    return frames, np.array([0] * SUM_REAL + [1] * SUM_FAKE)


def _snapshot(metrics, grads, params_sd, stats):
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params": {k: v.detach().clone() for k, v in params_sd.items()}, "stats": stats}


@pytest.fixture(scope="module")
def two_pass_runs(b0):
    """Three two-pass steps on each side; snapshots after steps 1 and 3.
    The pass-2 inputs take the frequency style mix, then the noise, then the
    blur (the spatial mix's tie order is the sort's own choice, see
    test_torch_perturb)."""
    jm, v = b0
    tx_j = optax.chain(_recorder(), joptim.build_optimizer(CFG, v["params"])[0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=tx_j.init(v["params"]))
    jstep = jax.jit(jax_make_train_step(jm, tx_j, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE,
                                        preprocess=JaxDevicePipeline(hflip_p=0.5)))
    tx = RecordingAdam(**toptim.build_optimizer(CFG)[0].__dict__)
    state = create_train_state(_b0_model(v), tx, device="cpu")
    step = make_train_step(tx, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE,
                           preprocess=DevicePipeline(hflip_p=0.5))
    frames, labels = _batch()
    keys = [_step_key(0, "freq_style"), _step_key(0, "noise"), _step_key(0, "blur")]
    snaps = {}
    for i, key in enumerate(keys, start=1):
        jstate, jmet, jcls = jstep(jstate, {"image": jnp.asarray(frames),
                                            "label": jnp.asarray(labels)}, key)
        state, tmet, tcls = step(state, {"image": torch.from_numpy(frames),
                                         "label": torch.from_numpy(labels)}, None,
                                 _step_draws(key))
        assert tcls.shape == tuple(jcls.shape) == (N, 2)
        if i in (1, 3):
            jgrads = [state_dict_from_jax({"params": g}) for g in jstate.opt_state[0][::-1]]
            jsd = state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
            snaps[i] = {
                "jax": _snapshot(jmet, jgrads, jsd, jstate.batch_stats),
                "port": _snapshot(tmet, tx.seen, state.model.state_dict(), None),
                "step": state.step,
            }
    return snaps


# Tolerances, after 1 step / after 3 steps. Losses: rtol. Gradients: per
# tensor, |‖g_port‖ − ‖g_jax‖| <= rel·‖g_jax‖ + floor·‖all gradients‖; the
# floor covers tensors whose gradient is zero but for rounding (a BatchNorm
# bias followed by a 1x1 conv and a train-mode BatchNorm, which cancels any
# shift), norms near 1e-7 of the total. Params: Adam turns the sign of such
# rounding noise into a full step, at most ~1.1·lr for amsgrad, so two runs
# may differ by 2.2·lr per update in any element: atol 2.2·lr·updates.
# Running statistics: |diff| <= rel·max|ref| per tensor.
STEP_TOL = {
    1: dict(loss_rtol=1e-4, grad_rel=1e-3, grad_floor=1e-6, updates=2, stat_rel=1e-3),
    3: dict(loss_rtol=1e-2, grad_rel=2e-2, grad_floor=2e-4, updates=6, stat_rel=5e-3),
}


@pytest.mark.parametrize("after", [1, 3])
def test_train_step_matches_jax(two_pass_runs, after):
    snap = two_pass_runs[after]
    assert snap["step"] == after
    assert_step_matches(snap, STEP_TOL[after])


def assert_step_matches(snap, tol):
    """A snapshot's port side against its JAX side at ``tol``: the metrics,
    both gradients per tensor by the norm, the params, the running
    statistics. An ``sf_rel`` in ``tol`` replaces ``grad_rel`` for the
    sf_coef scalars."""
    jax_s, port = snap["jax"], snap["port"]
    assert set(port["metrics"]) == set(jax_s["metrics"])
    for k, ref in jax_s["metrics"].items():
        np.testing.assert_allclose(port["metrics"][k], ref, rtol=tol["loss_rtol"], atol=1e-6,
                                   err_msg=k)
    for label, gj, gt in zip(("pass-1 gradient", "update-2 gradient"), jax_s["grads"],
                             port["grads"]):
        assert set(gt) == set(gj) - {"bottleneck.bias"}
        total = sum(float(t.norm()) ** 2 for t in gj.values()) ** 0.5
        for name, ref in gj.items():
            if name in gt:
                nj, nt = float(ref.norm()), float(gt[name].norm())
                rel = tol.get("sf_rel", tol["grad_rel"]) if name.endswith("sf_coef") \
                    else tol["grad_rel"]
                assert abs(nt - nj) <= rel * nj + tol["grad_floor"] * total, \
                    f"{label} {name}: |g| {nt} vs {nj} (all {total})"
    atol = 2.2 * LR * tol["updates"]
    for name, ref in jax_s["params"].items():
        got = port["params"][name]
        if "running" in name:
            bound = tol["stat_rel"] * float(ref.abs().max())
            assert float((got - ref).abs().max()) <= bound, name
        elif "num_batches_tracked" not in name:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def normal_step_jax(b0):
    """One single-pass JAX step of the b0 twin, compiled once for every
    route the port is held against; the flip mask of its key."""
    jm, v = b0
    tx_j = optax.chain(_recorder(), joptim.build_optimizer(CFG, v["params"])[0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=tx_j.init(v["params"]))
    jstep = jax.jit(jax_make_normal_train_step(jm, tx_j, CFG, SUM_REAL, SUM_FAKE,
                                               preprocess=JaxDevicePipeline(hflip_p=0.5)))
    frames, labels = _batch()
    key = jax.random.PRNGKey(3)
    _, kpre = jax.random.split(key)
    flip = np.array(jax.random.uniform(jax.random.split(kpre)[1], (N, 1, 1, 1)) < 0.5)
    jstate, jmet, _ = jstep(jstate, {"image": jnp.asarray(frames), "label": jnp.asarray(labels)},
                            key)
    return jstate, jmet, flip


# the port's SFConv routes: K2 everywhere, and K3 at every square SFConv
# width of the b0 twin at 64² (16, 8, 4, 2); the JAX step runs its CPU
# route, which computes the same function
ROUTES = {"K2": (), "K3": (16, 8, 4, 2)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_normal_train_step_matches_jax(b0, normal_step_jax, monkeypatch, route):
    """One single-pass step: losses rtol 1e-4, the gradient per tensor as
    above, params atol 2.2·lr (one update), running statistics 1e-3. On the
    K3 route every SFConv frequency branch goes through sfconv_freq_v4."""
    _, v = b0
    jstate, jmet, flip = normal_step_jax
    calls = {"v4": 0}
    v4 = tl.sfconv_freq_v4

    def counted(x, w):
        calls["v4"] += 1
        return v4(x, w)

    monkeypatch.setattr(tl, "sfconv_freq_v4", counted)
    tx = RecordingAdam(**toptim.build_optimizer(CFG)[0].__dict__)
    state = create_train_state(_b0_model(v, ROUTES[route]), tx, device="cpu")
    step = make_normal_train_step(tx, CFG, SUM_REAL, SUM_FAKE,
                                  preprocess=DevicePipeline(hflip_p=0.5))
    frames, labels = _batch()
    state, tmet, _ = step(state, {"image": torch.from_numpy(frames),
                                  "label": torch.from_numpy(labels)}, None,
                          StepDraws(flip=torch.from_numpy(flip.reshape(-1))))
    sfconvs = sum(isinstance(m, tl.SFConv) for m in state.model.modules())
    assert calls["v4"] == (sfconvs if ROUTES[route] else 0)
    assert state.step == 1 and set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)
    gj, gt = state_dict_from_jax({"params": jstate.opt_state[0][0]}), tx.seen[-1]
    total = sum(float(t.norm()) ** 2 for t in gj.values()) ** 0.5
    for name, t in gt.items():
        nj, nt = float(gj[name].norm()), float(t.norm())
        assert abs(nt - nj) <= 1e-3 * nj + 1e-6 * total, name
    jsd = state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    sd = state.model.state_dict()
    for name, ref in jsd.items():
        if "running" in name:
            assert float((sd[name] - ref).abs().max()) <= 1e-3 * float(ref.abs().max()), name
        elif "num_batches_tracked" not in name:
            np.testing.assert_allclose(sd[name].numpy(), ref.numpy(), rtol=0, atol=2.2 * LR,
                                       err_msg=name)


def test_faithful_accumulation_and_kl_switch_change_the_step(b0):
    """faithful_grad_accumulation=False applies g2 alone at update 2, so the
    params differ; the pass-2 mask loss is the sparsity mean before the KL
    switch and the KL after it."""
    _, v = b0
    frames, labels = _batch()
    batch = {"image": torch.from_numpy(frames), "label": torch.from_numpy(labels)}
    draws = _step_draws(_step_key(0, "noise"))
    results = {}
    for name, faithful, num_steps in (("faithful", True, 10 ** 6), ("fixed", False, 10 ** 6),
                                      ("kl", True, 1)):
        tx = toptim.build_optimizer(CFG)[0]
        state = create_train_state(_b0_model(v), tx, device="cpu")
        step = make_train_step(tx, CFG, num_steps, SUM_REAL, SUM_FAKE, faithful,
                               preprocess=DevicePipeline(hflip_p=0.5))
        state, met, _ = step(state, batch, None, draws)
        results[name] = (met, state.model.state_dict())
    gap = max(float((a - results["fixed"][1][k]).abs().max())
              for k, a in results["faithful"][1].items() if "num_batches" not in k)
    assert gap > 0
    assert float(results["faithful"][0]["freq_mask_loss"]) > 0.05  # a sigmoid mean
    assert float(results["kl"][0]["freq_mask_loss"]) < float(results["faithful"][0]["freq_mask_loss"])


def test_train_step_draws_from_the_generator(b0):
    """Without injected draws the flip, the perturbation and the dropout
    masks come from the generator: the same seed repeats the step exactly."""
    _, v = b0
    frames, labels = _batch()
    batch = {"image": torch.from_numpy(frames), "label": torch.from_numpy(labels)}
    out = []
    for _ in range(2):
        model = _b0_model(v)
        model.drop_rate = model.feat_drop_rate = 0.3
        model.backbone.drop_connect_rate = 0.3
        tx = toptim.build_optimizer(CFG)[0]
        state = create_train_state(model, tx, device="cpu")
        step = make_train_step(tx, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE,
                               preprocess=DevicePipeline(hflip_p=0.5))
        state, met, _ = step(state, batch, torch.Generator().manual_seed(11))
        out.append(({k: float(m) for k, m in met.items()}, state.model.state_dict()))
    assert out[0][0] == out[1][0]
    for k, a in out[0][1].items():
        assert torch.equal(a, out[1][1][k]), k


def test_train_step_needs_a_generator_or_draws(b0):
    _, v = b0
    tx = toptim.build_optimizer(CFG)[0]
    state = create_train_state(_b0_model(v), tx, device="cpu")
    frames, labels = _batch()
    batch = {"image": torch.from_numpy(frames), "label": torch.from_numpy(labels)}
    for step in (make_train_step(tx, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE),
                 make_normal_train_step(tx, CFG, SUM_REAL, SUM_FAKE)):
        with pytest.raises(ValueError, match="generator"):
            step(state, batch)
    assert state.step == 0


def test_create_train_state_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = types.SimpleNamespace(to=lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(model, toptim.build_optimizer(CFG)[0])
