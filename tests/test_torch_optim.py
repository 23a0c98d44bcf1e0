"""The rest of the port's optimizers against the JAX package on the CPU: sgd
(with momentum), asgd and its Polyak average, adamax, adadelta, adagrad and
rmsprop against optax, the fallback without an ``optimizer:`` section,
every optimizer's state through ``opt.pt`` (and the earlier ``opt.pt``
layout), ``broadcast_state`` over two gloo ranks; and ``AUCMeter`` and
``get_image_size``."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_ranks
from tests.test_torch_train import _grads, _param_module
from tests.torch_tmp import drop_tmp_path  # noqa: F401 (autouse fixture)
from unidefense_torch.checkpoint import CheckpointManager
from unidefense_torch.models import efficientnet as teff
from unidefense_torch.train import optim as toptim
from unidefense_torch.train.step import TrainState
from unidefense_torch.utils.meters import AUCMeter
from unidefense_tpu.models import efficientnet as jeff
from unidefense_tpu.train import optim as joptim
from unidefense_tpu.utils.meters import AUCMeter as JaxAUCMeter


# ------------------------------------------------------------ optimizers

# the six optimizers no model YAML names, with YAML keys JAX swallows
# (nesterov, dampening) and the second meaning of alpha; asgd with t0 2 takes
# the averaging branch (mu < 1) from its fourth update
OTHERS = {
    "sgd-momentum": {"name": "sgd", "momentum": 0.9, "nesterov": False, "dampening": 0},
    "sgd": {"name": "sgd"},
    "asgd": {"name": "asgd"},
    "asgd-averaging": {"name": "asgd", "t0": 2, "lambd": 1e-3, "alpha": 0.6},
    "adamax": {"name": "adamax", "betas": [0.8, 0.99]},
    "adadelta": {"name": "adadelta", "eps": 1e-6},
    "adagrad": {"name": "adagrad"},
    "rmsprop": {"name": "rmsprop", "alpha": 0.9},
}


def _cfg(opt: dict, lr: float = 1e-2, wd: float = 0.1) -> dict:
    return {"optimizer": dict(opt, lr=lr, weight_decay=wd), "warmup_step": 1,
            "scheduler": {"name": "StepLR", "step_size": 1, "gamma": 0.5}}


def _run_both(cfg: dict, updates: int = 5, lr_scale_from: int = 3):
    """``updates`` updates of the port and of JAX's optax chain on the same
    gradients (their second moment falls), the plateau factor 0.5 from
    update ``lr_scale_from``; yields (update, port module, JAX params, port
    state, JAX state) after each."""
    m = _param_module()
    jparams = {k: jnp.asarray(p.detach().numpy()) for k, p in m.named_parameters()}
    tx_j, _ = joptim.build_optimizer(cfg, jparams)
    js = tx_j.init(jparams)
    tx, _ = toptim.build_optimizer(cfg)
    ts = tx.init(m)
    for step in range(updates):
        g = _grads(step)
        lr_scale = 0.5 if step >= lr_scale_from else None
        u, js = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, js, jparams)
        if lr_scale is not None:  # the JAX step scales the chain's output
            u = jax.tree.map(lambda v: v * lr_scale, u)
        jparams = optax.apply_updates(jparams, u)
        for k, p in m.named_parameters():
            p.grad = torch.from_numpy(g[k])
        tx.update(m, ts, lr_scale)
        yield step, m, jparams, ts, js


@pytest.mark.parametrize("opt", OTHERS.values(), ids=OTHERS.keys())
def test_other_optimizers_match_optax(opt):
    """Five updates with warm-up, StepLR, coupled masked weight decay and
    ``lr_scale`` on the last two: params after every update, rtol 1e-5 and
    atol 1e-7 (fp32, another operation order)."""
    for step, m, jparams, ts, _ in _run_both(_cfg(opt)):
        for k, p in m.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} after update {step + 1}")
    assert ts.count == 5


@pytest.mark.parametrize("opt", [OTHERS["asgd"], OTHERS["asgd-averaging"]],
                         ids=["mu-1", "averaging"])
def test_asgd_averaged_params_match_jax(opt):
    """ASGD's Polyak average after every update against JAX's
    ``averaged_params`` (rtol 1e-5, atol 1e-7), its eta and mu against the
    JAX state's (rtol 1e-6: JAX keeps them in fp32); with mu 1 the average
    is the parameters."""
    for step, m, _, ts, js in _run_both(_cfg(opt), lr_scale_from=5):
        got, ref = toptim.averaged_params(ts), joptim.averaged_params(js)
        assert set(got) == set(ref) == {"w", "bias", "s"}
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} after update {step + 1}")
        np.testing.assert_allclose(ts.scalars["eta"], float(js.eta), rtol=1e-6)
        np.testing.assert_allclose(ts.scalars["mu"], float(js.mu), rtol=1e-6)
        if ts.scalars["mu"] == 1.0 and "t0" not in opt:
            assert all(torch.equal(v, dict(m.named_parameters())[k].detach())
                       for k, v in got.items())
    assert toptim.averaged_params(toptim.build_optimizer(_cfg({"name": "adamw"}))[0]
                                  .init(_param_module())) is None


def test_no_optimizer_section_trains_with_sgd_as_jax():
    """A ``config:`` with no ``optimizer:`` builds sgd at lr 0.01 in both
    packages: the same five updates (rtol 1e-6)."""
    tx, schedule = toptim.build_optimizer({})
    assert isinstance(tx, toptim.SGD) and tx.momentum == 0.0 and schedule(0) == 0.01
    for step, m, jparams, _, _ in _run_both({}):
        for k, p in m.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       err_msg=f"{k} after update {step + 1}")


@pytest.mark.parametrize("name", ["sgd", "asgd", "adamax", "adadelta", "adagrad", "rmsprop",
                                  "adam", "adamw"])
def test_get_optimizer_builds_every_name(name):
    tx = toptim.get_optimizer(name.upper(), toptim.build_lr_schedule(0.1))
    assert isinstance(tx, toptim.Optimizer)


# ------------------------------------------------------------ opt.pt

ALL = {**OTHERS, "adamw-amsgrad": {"name": "adamw", "amsgrad": True},
       "adam": {"name": "adam"}}


def _state_of(model, tx) -> TrainState:
    return TrainState(model=model, opt_state=tx.init(model))


def _update(state, tx, step):
    for k, p in state.model.named_parameters():
        p.grad = torch.from_numpy(_grads(step)[k])
    tx.update(state.model, state.opt_state, state.lr_scale)


@pytest.mark.parametrize("opt", ALL.values(), ids=ALL.keys())
def test_optimizer_state_round_trips_through_opt_pt(opt, tmp_path):
    """Three updates, a checkpoint, the fourth and fifth; the checkpoint
    restored into a fresh state and its fourth and fifth: parameters and
    every slot bit for bit, the count and scalars equal."""
    cfg = _cfg(opt)
    tx, _ = toptim.build_optimizer(cfg)
    straight = _state_of(_param_module(), tx)
    for step in range(3):
        _update(straight, tx, step)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(straight, {"best_step": 3})
    resumed = _state_of(_param_module(seed=9), tx)
    resumed, meta = ckpt.restore(resumed)
    assert meta["best_step"] == 3 and resumed.opt_state.count == 3
    for step in (3, 4):
        _update(straight, tx, step)
        _update(resumed, tx, step)
    a, b = straight.opt_state, resumed.opt_state
    assert a.count == b.count == 5 and a.scalars == b.scalars
    assert list(a.slots) == list(b.slots) and list(a.slots) == list(tx.init(_param_module()).slots)
    assert all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))
    for (k, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), k


def test_pr12_opt_pt_restores_into_adam(tmp_path):
    """An ``opt.pt`` of the earlier layout ({count, mu, nu, nu_max} at the
    top level, nu_max empty without amsgrad) restores into Adam; a file of
    another optimizer's slots is refused."""
    for amsgrad in (True, False):
        tx, _ = toptim.build_optimizer(_cfg({"name": "adamw", "amsgrad": amsgrad}))
        state = _state_of(_param_module(), tx)
        for step in range(2):
            _update(state, tx, step)
        ckpt = CheckpointManager(str(tmp_path / str(amsgrad)))
        ckpt.save(state, {})
        path = os.path.join(ckpt.ckpt_dir, "latest", "opt.pt")
        slots = state.opt_state.slots
        torch.save({"count": 2, "mu": slots["mu"], "nu": slots["nu"],
                    "nu_max": slots.get("nu_max", {})}, path)
        fresh, _ = ckpt.restore(_state_of(_param_module(seed=9), tx))
        assert fresh.opt_state.count == 2 and list(fresh.opt_state.slots) == list(slots)
        assert all(torch.equal(x, y) for x, y in zip(fresh.opt_state.tensors(),
                                                      state.opt_state.tensors()))
    other, _ = toptim.build_optimizer(_cfg({"name": "rmsprop"}))
    with pytest.raises(ValueError, match="slots"):
        ckpt.restore(_state_of(_param_module(), other))


def test_broadcast_state_carries_every_slot(tmp_path):
    """Two gloo ranks with different weights and ASGD and amsgrad states:
    after ``broadcast_state`` rank 1's model and every slot are rank 0's."""
    ranks = torch_ranks.spawn(torch_ranks.broadcast_states, str(tmp_path))
    for name in ("asgd", "adamw"):
        before0, after0 = ranks[0][name]
        before1, after1 = ranks[1][name]
        assert before0 != before1 and after0 == after1 == before0, name


# ------------------------------------------------------------ utilities

def test_auc_meter_matches_jax(tmp_path, capsys):
    """AUC, the printed EER line and the pickled [fpr, tpr, thresholds]
    against the JAX package's AUCMeter on the same scores (ties included):
    equal to the last bit."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 100)
    s = y * 0.6 + rng.random(100) * 0.4
    s[::7] = 0.5
    curves, aucs, lines = [], [], []
    for cls, sub in ((AUCMeter, "port"), (JaxAUCMeter, "jax")):
        m = cls()
        m.update(s[:50], y[:50])
        m.update(s[50:], y[50:])
        aucs.append(m.mean_auc())
        os.makedirs(tmp_path / sub)
        m.curve(str(tmp_path / sub))
        lines.append(capsys.readouterr().out)
        with open(tmp_path / sub / "roc_curve.pickle", "rb") as f:
            curves.append(pickle.load(f))
    assert aucs[0] == aucs[1] and 0.5 < aucs[0] <= 1.0
    assert lines[0] == lines[1] and lines[0].startswith("# EER:")
    for a, b in zip(*curves):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(teff.PARAMS))
def test_get_image_size_matches_jax(name):
    assert teff.get_image_size(name) == jeff.get_image_size(name)
