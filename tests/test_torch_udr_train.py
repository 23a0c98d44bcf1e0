"""One two-pass UDR18 training step of the port against the JAX step on the
CPU in fp32 (config_template/ocim/model_udr18.yml's optimizer: AdamW with
amsgrad, weight decay 5e-5, no scheduler).

64², 2 real + 2 fake, every drop rate 0, the same bridged weights (sf_coef
0, random BatchNorm statistics and scales), and the flip mask and
perturbation draws taken from the JAX step's own key, as in
test_torch_train. A file of its own, so that its JAX step compile runs on a
worker beside the other files'."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import chip_smoke
from tests.test_torch_models import _randomise
from tests.test_torch_resnet import _scaled
from tests.test_torch_train import (
    N, NUM_STEPS, STEP_TOL, SUM_FAKE, SUM_REAL, RecordingAdam, _batch, _recorder, _snapshot,
    _step_draws, _step_key, assert_step_matches)
from unidefense_torch.data.transforms import DevicePipeline
from unidefense_torch.models.convert import state_dict_from_jax
from unidefense_torch.models.registry import build_model
from unidefense_torch.train import optim as toptim
from unidefense_torch.train.step import create_train_state, make_train_step
from unidefense_tpu.data.transforms import DevicePipeline as JaxDevicePipeline
from unidefense_tpu.models.unidefense import UniDefenseModelRes18
from unidefense_tpu.train import optim as joptim
from unidefense_tpu.train.step import TrainState as JaxTrainState
from unidefense_tpu.train.step import make_train_step as jax_make_train_step

# STEP_TOL[1] holds the b0 twin of UDEB4; UDR18's step is held where the
# JAX step itself is not determined more closely. In float64 on both sides
# (tests/probe_udr_float64.py) the JAX step from weights moved by 1e-14 of
# themselves moves its own losses by up to 1.2e-3 (freq_mask_loss), its
# gradient norms above 1e-3 of the total by up to 2.1e-3 and its sf_coef
# gradients (sums over every element of the freq - spatial gap that mostly
# cancel) by up to 9.5%, while the port's moves by at most 1.7e-10; the port
# is closer to JAX than that (2.9e-4, 1.7e-3, 4.2%). In fp32 here: losses
# within 3.3e-4 (fac_loss), gradient norms within 0.55% and sf_coef within
# 6.2%, params within STEP_TOL[1]'s 2.2 lr per update, running statistics
# within 1.2e-3 of their max (spat_filter's BatchNorm).
UDR_STEP_TOL = dict(STEP_TOL[1], loss_rtol=1e-3, grad_rel=6e-3, sf_rel=0.1, stat_rel=2e-3)

# config_template/ocim/model_udr18.yml's config section
CFG = chip_smoke.model_spec("UDR18")["config"]


def test_udr18_train_step_matches_jax():
    """Losses, both gradients by the norm per tensor, params after update 2
    and the running statistics, at UDR_STEP_TOL; the pass-2 input takes the
    frequency style mix."""
    jm = UniDefenseModelRes18(drop_rate=0.0, feat_drop_rate=0.0, dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((N, 64, 64, 3)), train=False)
    v = _scaled(_randomise(v))
    tx_j = optax.chain(_recorder(), joptim.build_optimizer(CFG, v["params"])[0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=tx_j.init(v["params"]))
    jstep = jax.jit(jax_make_train_step(jm, tx_j, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE,
                                        preprocess=JaxDevicePipeline(hflip_p=0.5)))

    model = build_model("UDR18", {"drop_rate": 0.0, "feat_drop_rate": 0.0})
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    tx = RecordingAdam(**toptim.build_optimizer(CFG)[0].__dict__)
    state = create_train_state(model, tx, device="cpu")
    step = make_train_step(tx, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE,
                           preprocess=DevicePipeline(hflip_p=0.5))

    frames, labels = _batch()
    key = _step_key(0, "freq_style")
    jstate, jmet, jcls = jstep(jstate, {"image": jnp.asarray(frames),
                                        "label": jnp.asarray(labels)}, key)
    state, tmet, tcls = step(state, {"image": torch.from_numpy(frames),
                                     "label": torch.from_numpy(labels)}, None, _step_draws(key))
    assert tcls.shape == tuple(jcls.shape) == (N, 2)
    np.testing.assert_allclose(tcls.numpy(), np.asarray(jcls), rtol=1e-3, atol=1e-3)
    jgrads = [state_dict_from_jax({"params": g}) for g in jstate.opt_state[0][::-1]]
    jsd = state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    assert state.step == 1
    assert_step_matches({"jax": _snapshot(jmet, jgrads, jsd, jstate.batch_stats),
                         "port": _snapshot(tmet, tx.seen, state.model.state_dict(), None)},
                        UDR_STEP_TOL)
