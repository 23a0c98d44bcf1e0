"""The port's data parallelism (unidefense_torch/parallel, the synced
BatchNorm, the step's group, the multi-device Predictor) against the JAX
package on the CPU in fp32. The port's ranks are gloo processes spawned
through ``parallel.launch`` (tests/torch_ranks.py, one intra-op thread
each); JAX runs ``shard_map`` on a 2-device mesh of the conftest's 8
forced CPU devices."""

from concurrent import futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import chip_smoke
from tests import torch_ranks
from tests.test_torch_models import _bridge, _init, _nchw, _nhwc, _randomise, _x
from tests.test_torch_perturb import _branch, jax_perturb_draws
from tests.test_torch_serving import _port, udr18  # noqa: F401 (fixture)
from tests.test_torch_train import _recorder, _snapshot, assert_step_matches
from tests.test_torch_resnet import _scaled
from tests.test_torch_udr_train import UDR_STEP_TOL
from tests.torch_tmp import drop_tmp_path  # noqa: F401 (autouse fixture)
from unidefense_torch.data.pipeline import EpochSampler
from unidefense_torch.inference import Predictor
from unidefense_torch.models.convert import state_dict_from_jax
from unidefense_torch.parallel import split_device_batch
from unidefense_torch.train.step import StepDraws
from unidefense_tpu.data.pipeline import EpochSampler as JaxEpochSampler
from unidefense_tpu.data.transforms import DevicePipeline as JaxDevicePipeline
from unidefense_tpu.models import layers as jl
from unidefense_tpu.models.unidefense import UniDefenseModelRes18
from unidefense_tpu.parallel import mesh as jmesh
from unidefense_tpu.train import optim as joptim
from unidefense_tpu.train.step import TrainState as JaxTrainState
from unidefense_tpu.train.step import make_normal_train_step as jax_make_normal_train_step
from unidefense_tpu.train.step import make_train_step as jax_make_train_step

WORLD = 2
SIZE = 32
SUM_REAL = SUM_FAKE = 2  # per rank, as per device in JAX
NUM_STEPS = 10  # the KL switch at 1.0: step 1 takes the sparsity loss, step 2 the KL
CFG = chip_smoke.model_spec("UDR18")["config"]  # config_template/ocim/model_udr18.yml


# ------------------------------------------------------------- mesh helpers

@pytest.mark.parametrize("num_devices", [1, 2, 4])
def test_split_device_batch_matches_jax(num_devices):
    rng = np.random.default_rng(num_devices)
    real, fake = (rng.integers(0, 256, (8, 3, 5, 3), dtype=np.uint8) for _ in range(2))
    lr, lf = np.zeros(8, np.int64), np.ones(8, np.int64)
    got = split_device_batch(real, lr, fake, lf, num_devices)
    want = jmesh.split_device_batch(real, lr, fake, lf, num_devices)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_split_device_batch_refuses_what_jax_refuses():
    real, fake = np.zeros((6, 2, 2, 3), np.uint8), np.zeros((4, 2, 2, 3), np.uint8)
    lr, lf = np.zeros(6, np.int64), np.ones(4, np.int64)
    with pytest.raises(ValueError) as jax_err:
        jmesh.split_device_batch(real, lr, fake, lf, 4)
    with pytest.raises(ValueError) as err:
        split_device_batch(real, lr, fake, lf, 4)
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("num_shards", [2, 3])
def test_epoch_sampler_shards_match_jax(num_shards):
    """Each shard's batches, epoch by epoch, with wrap-around padding and
    with the short batch dropped, as JAX's per-process samplers draw them."""
    for n, bs, kw in ((10, 2, {"pad_last": True}), (11, 2, {"drop_last": True}),
                      (7, 3, {"pad_last": True})):
        for shard in range(num_shards):
            got = EpochSampler(n, bs, shuffle=True, shard_id=shard, num_shards=num_shards, **kw)
            want = JaxEpochSampler(n, bs, shuffle=True, shard_id=shard, num_shards=num_shards,
                                   **kw)
            for epoch in (0, 3):
                got.set_epoch(epoch)
                want.set_epoch(epoch)
                assert [b.tolist() for b in got] == [b.tolist() for b in want]
                assert len(got) == len(want)


def test_all_gather_objects_ragged(tmp_path):
    """Pickles of different sizes from each rank, gathered in rank order
    (tests/test_multihost.py:66-91)."""
    got = torch_ranks.spawn(torch_ranks.gather_ragged, str(tmp_path))
    for r in range(WORLD):
        assert got[r] == [({"videos_0": [0]}, 0), ({"videos_1": [0, 1, 2, 3]}, 10)]


# --------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("ndim", [2, 4])
def test_sync_batchnorm_matches_jax(ndim, tmp_path):
    """Each rank with its half of the batch against JAX's
    BatchNorm(axis_name=...) under shard_map on create_mesh(2): the output,
    both running statistics (momentum 0.01, eps 1e-3) and the gradients of
    the input, the scale and the bias of loss sum(y * c) per rank, within
    rtol = atol = 1e-5."""
    shape = (6, 5) if ndim == 2 else (4, 6, 7, 5)  # NHWC on the JAX side
    x = _x(shape, 1) * 2.0 + 0.5
    c = _x(shape, 4)
    jm = jl.BatchNorm(momentum=0.01, epsilon=1e-3, axis_name=jmesh.DATA_AXIS)
    v = _init(jl.BatchNorm(momentum=0.01, epsilon=1e-3), jnp.asarray(x),
              use_running_average=True)
    v["params"]["scale"], v["params"]["bias"] = _x((5,), 2), _x((5,), 3)

    def per_device(params, stats, xs, cs):
        def loss(params, xs):
            y, mut = jm.apply({"params": params, "batch_stats": stats}, xs,
                              use_running_average=False, mutable=["batch_stats"])
            return jnp.sum(y * cs), (y, mut["batch_stats"])

        (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                           has_aux=True)(params, xs)
        return y, new_stats, gp, gx

    d = P(jmesh.DATA_AXIS)
    fn = jax.jit(jax.shard_map(per_device, mesh=jmesh.create_mesh(WORLD),
                               in_specs=(P(), P(), d, d), out_specs=(d, P(), d, d),
                               check_vma=False))
    jy, jstats, jgp, jgx = fn(v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(c))

    def to_torch(a):
        return np.ascontiguousarray(_nchw(a).numpy()) if ndim == 4 else a

    halves = np.split(x, WORLD)
    got = torch_ranks.spawn(torch_ranks.batchnorm, str(tmp_path),
                            [to_torch(h) for h in halves],
                            [to_torch(h) for h in np.split(c, WORLD)],
                            _bridge(v, ("backbone", "bn0"), "backbone._bn0."), 0.01, 1e-3)
    tol = dict(rtol=1e-5, atol=1e-5)
    gp = jax.tree.map(lambda a: np.asarray(a).reshape(WORLD, -1), jgp)
    for r, out in enumerate(got):
        from_torch = (lambda t: _nhwc(t)) if ndim == 4 else (lambda t: t.numpy())
        np.testing.assert_allclose(from_torch(out["y"]), np.split(np.asarray(jy), WORLD)[r], **tol)
        np.testing.assert_allclose(from_torch(out["dx"]), np.split(np.asarray(jgx), WORLD)[r],
                                   **tol)
        np.testing.assert_allclose(out["dw"].numpy(), gp["scale"][r], **tol)
        np.testing.assert_allclose(out["db"].numpy(), gp["bias"][r], **tol)
        np.testing.assert_allclose(out["mean"].numpy(), np.asarray(jstats["mean"]), **tol)
        np.testing.assert_allclose(out["var"].numpy(), np.asarray(jstats["var"]), **tol)


# -------------------------------------------------------------- the steps

def _device_draws(key, d) -> StepDraws:
    """Device ``d``'s flip mask and perturbation draws in JAX's step with
    ``key``: its key is fold_in(key, d), split as step.py:211-216 splits it."""
    _, _, kp, kpre = jax.random.split(jax.random.fold_in(key, d), 4)
    _, kf = jax.random.split(kpre)
    n = SUM_REAL + SUM_FAKE
    flip = np.array(jax.random.uniform(kf, (n, 1, 1, 1)) < 0.5).reshape(-1)
    return StepDraws(flip=torch.from_numpy(flip),
                     perturb=jax_perturb_draws(kp, (n, SIZE, SIZE, 3)))


def _normal_draws(key, d) -> StepDraws:
    """The single-pass step's flip mask on device ``d`` (step.py:323-326)."""
    _, kpre = jax.random.split(jax.random.fold_in(key, d))
    _, kf = jax.random.split(kpre)
    flip = np.array(jax.random.uniform(kf, (SUM_REAL + SUM_FAKE, 1, 1, 1)) < 0.5).reshape(-1)
    return StepDraws(flip=torch.from_numpy(flip))


def _step_keys(count: int) -> list:
    """Keys on which no device's pass-2 input takes the spatial style mix
    (its sort breaks ties in its own order, test_torch_perturb), the first
    taking the frequency mix on device 0."""
    keys = []
    for s in range(400):
        key = jax.random.PRNGKey(s)
        branches = [_branch(_device_draws(key, d).perturb) for d in range(WORLD)]
        if "spatial_style" in branches or (not keys and branches[0] != "freq_style"):
            continue
        keys.append(key)
        if len(keys) == count:
            return keys
    raise AssertionError("no keys")


@pytest.fixture(scope="module")
def udr18_vars():
    jm = UniDefenseModelRes18(drop_rate=0.0, feat_drop_rate=0.0, dtype=jnp.float32,
                              axis_name=jmesh.DATA_AXIS)
    plain = UniDefenseModelRes18(drop_rate=0.0, feat_drop_rate=0.0, dtype=jnp.float32)
    v = jax.jit(plain.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((4, SIZE, SIZE, 3)), train=False)
    # test_torch_udr_train's weights, on which UDR_STEP_TOL was measured
    return jm, _scaled(_randomise(v))


def _batches():
    """Each rank's local batch (2 real + 2 fake) and JAX's global batch
    [d0-real, d0-fake, d1-real, d1-fake]."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (WORLD * 4, SIZE, SIZE, 3), dtype=np.uint8)
    labels = np.array([0, 0, 1, 1] * WORLD)
    real, fake = frames[labels == 0], frames[labels == 1]
    g_frames, g_labels = split_device_batch(real, labels[labels == 0], fake,
                                            labels[labels == 1], WORLD)
    local = [(g_frames[4 * r:4 * r + 4], g_labels[4 * r:4 * r + 4]) for r in range(WORLD)]
    return local, g_frames, g_labels


def _jax_runs(jm, v, two_pass: bool, keys):
    tx = optax.chain(_recorder(), joptim.build_optimizer(CFG, v["params"])[0])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    pre = JaxDevicePipeline(hflip_p=0.5)
    step_fn = (jax_make_train_step(jm, tx, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE,
                                   axis_name=jmesh.DATA_AXIS, preprocess=pre) if two_pass else
               jax_make_normal_train_step(jm, tx, CFG, SUM_REAL, SUM_FAKE,
                                          axis_name=jmesh.DATA_AXIS, preprocess=pre))
    mesh = jmesh.create_mesh(WORLD)
    step = jmesh.shard_train_step(step_fn, mesh)
    _, g_frames, g_labels = _batches()
    # placed as the step returns it, so that step 2 reuses step 1's compile
    state = jax.device_put(state, NamedSharding(mesh, P()))
    batch = jax.device_put({"image": g_frames, "label": g_labels},
                           NamedSharding(mesh, P(jmesh.DATA_AXIS)))
    snaps = []
    for key in keys:
        state, metrics, cls_out = step(state, batch, key)
        grads = [state_dict_from_jax({"params": g}) for g in state.opt_state[0][::-1]]
        sd = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
        snaps.append((_snapshot(metrics, grads, sd, state.batch_stats), np.asarray(cls_out)))
    return snaps


def _runs(jm, v, two_pass: bool, keys, tmp_path):
    """JAX's snapshots and the ranks' (spawned first, so that they run
    while JAX compiles)."""
    local, _, _ = _batches()
    draw = _device_draws if two_pass else _normal_draws
    draws = [[draw(key, r) for r in range(WORLD)] for key in keys]
    with futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(torch_ranks.spawn, torch_ranks.train_steps, str(tmp_path),
                           state_dict_from_jax(v), CFG, NUM_STEPS, local, draws, two_pass)
        return _jax_runs(jm, v, two_pass, keys), port.result()


def _check(jax_snaps, port, tol):
    for i, (jsnap, jcls) in enumerate(jax_snaps):
        assert port[0][i]["digest"] == port[1][i]["digest"], "ranks diverged"
        for r in range(WORLD):
            p = port[r][i]
            assert p["step"] == i + 1
            np.testing.assert_allclose(p["cls_out"].numpy(), jcls[4 * r:4 * r + 4],
                                       rtol=1e-3, atol=1e-3)
            assert_step_matches({"jax": jsnap, "port": _snapshot(
                p["metrics"], p["grads"], p["params"], None)}, tol)


def test_two_pass_step_matches_jax_across_ranks(udr18_vars, tmp_path):
    """Two ranks x (2 real + 2 fake), UDR18 at 32², every drop rate 0, each
    rank's flips and perturbation from JAX's per-device key, against
    shard_train_step(make_train_step(..., axis_name)) on create_mesh(2):
    after step 1 and after step 2 (past the KL switch), every rank's
    metrics (averaged over the ranks), both updates' gradients (averaged),
    params and running statistics at UDR_STEP_TOL (test_torch_udr_train:
    where JAX's own UDR18 step is determined), cls_out (rank-local) at
    1e-3; the ranks' states bitwise equal. The port reduces g1's mean plus
    g2 where JAX adds two means: one fp32 rounding, far inside the bound."""
    jm, v = udr18_vars
    _check(*_runs(jm, v, True, _step_keys(2), tmp_path), UDR_STEP_TOL)


def test_single_pass_step_matches_jax_across_ranks(udr18_vars, tmp_path):
    """make_normal_train_step across two ranks against JAX's under
    shard_map, one step, as above (its one gradient is the pass-1 one)."""
    jm, v = udr18_vars
    jax_snaps, port = _runs(jm, v, False, _step_keys(1), tmp_path)
    # one update: the recorders hold its gradient twice (the older is zeros
    # in JAX's and absent in the port's)
    jsnap, jcls = jax_snaps[0]
    jsnap["grads"] = jsnap["grads"][1:]
    for r in range(WORLD):
        port[r][0]["grads"] = port[r][0]["grads"][-1:]
    _check([(jsnap, jcls)], port, UDR_STEP_TOL)


# ---------------------------------------------------------------- Predictor

def test_predictor_across_devices_equals_one(udr18):  # noqa: F811
    """num_devices=2 (two replicas, on the CPU here) against one device on
    the same frames, within 1e-6; 8 frames at batch 4 and 6 at batch 4 (the
    last batch padded)."""
    _, v, frames = udr18
    one = _port(v)
    two = _port(v, num_devices=2)
    assert len(two._replicas) == 2 and two.param_bytes() == one.param_bytes()
    for f in (frames, frames[:6]):
        np.testing.assert_allclose(two.predict_frames(f), one.predict_frames(f), rtol=0,
                                   atol=1e-6)


def test_predictor_refuses_batches_and_devices_as_jax(udr18, monkeypatch):  # noqa: F811
    """batch_size % num_devices raises JAX's ValueError; num_devices above
    the cards of the host raises ValueError before a model is built."""
    from unidefense_tpu.inference import Predictor as JaxPredictor

    _, v, _ = udr18
    with pytest.raises(ValueError) as jax_err:
        JaxPredictor("UDR18", batch_size=4, num_devices=3)
    with pytest.raises(ValueError) as err:
        _port(v, num_devices=3)
    assert str(err.value) == str(jax_err.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exceeds the 1 CUDA device"):
        Predictor("UDR18", batch_size=4, num_devices=2)
