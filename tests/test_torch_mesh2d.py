"""The port's 2-D ('data', 'model') mode (unidefense_torch/parallel/mesh.py:
create_mesh_2d, shard_plan, the sharded gather, gspmd_train_step,
gather_state, create_hybrid_mesh; the steps' ``mesh``) against the JAX
package on the CPU in fp32. The port's ranks are gloo processes spawned
through ``parallel.launch`` (tests/torch_ranks.py, one intra-op thread
each); JAX's ``gspmd_train_step`` on ``create_mesh_2d(4, model_parallel=2)``
of the conftest's 8 forced CPU devices is the reference. The 2x2 steps run
once, in a module fixture, and every case reads them."""

from concurrent import futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.experimental import mesh_utils

import chip_smoke
from tests import torch_ranks
from tests.test_torch_models import _randomise
from tests.test_torch_perturb import _branch, jax_perturb_draws
from tests.test_torch_resnet import _scaled
from tests.test_torch_train import B0_DELIMITER, LR, _snapshot, assert_step_matches
from tests.test_torch_udr_train import UDR_STEP_TOL
from tests.torch_tmp import drop_tmp_path, module_tmp  # noqa: F401 (autouse fixture)
from unidefense_torch.data.transforms import DevicePipeline
from unidefense_torch.models.convert import _layout, state_dict_from_jax, torch_key
from unidefense_torch.models.registry import build_model
from unidefense_torch.parallel import mesh as tmesh
from unidefense_torch.train import optim as toptim
from unidefense_torch.train.perturb import PerturbDraws
from unidefense_torch.train.step import (
    StepDraws, create_train_state, make_normal_train_step, make_train_step)
from unidefense_tpu.data.transforms import DevicePipeline as JaxDevicePipeline
from unidefense_tpu.models.unidefense import UniDefenseModelEb4, UniDefenseModelRes18
from unidefense_tpu.parallel import mesh as jmesh
from unidefense_tpu.train import optim as joptim
from unidefense_tpu.train.step import TrainState as JaxTrainState
from unidefense_tpu.train.step import make_normal_train_step as jax_make_normal_train_step
from unidefense_tpu.train.step import make_train_step as jax_make_train_step

SIZE = 32
MP = 2
WORLD = 4  # a 2x2 mesh
# global batch: data rank 0 holds rows 0-3 (3 real + 1 fake), data rank 1
# rows 4-7 (4 fake)
N, SUM_REAL, SUM_FAKE = 8, 3, 5
NUM_STEPS = 5  # the KL switch at 0.5: step 1 takes the KL mask loss
MIN_SIZE = 1024  # shards the classifier (a dense), the deconvs and the convs of 1024 or more
CFG = chip_smoke.model_spec("UDR18")["config"]  # config_template/ocim/model_udr18.yml
SLOTS = ("mu", "nu", "nu_max")  # AdamW with amsgrad
# The 2x2 step against the port's one-process step on the global batch,
# its BatchNorms computing their statistics from the sums E[x] and E[x^2]
# as every data rank does (JAX's formula; the plain one-process step takes
# torch.var_mean). E[x^2] - E[x]^2 cancels where |mean| >> std, and AdamW's
# first updates move each weight by about lr g/|g| whatever its size, so
# any regrouping of the batch's sums moves UDR18's slots by up to 2e-3 and
# about 1e4 of its 19.6M weights past 1e-5 (up to 2.2 lr per update:
# PARAM_ATOL, the 1-D tests' and [dp-step]'s bound): the same one-process
# step with only the order of its rows changed (REORDER) moves as far as
# the 2x2 step does. ONE_BOUNDS holds each gap at twice what that
# reordering moved, or ONE_ATOL where that is less; beside each bound, the
# 2x2 step's gap and the reordering's, as read on the CPU (four gloo ranks,
# one thread each). cls_out stays within ONE_ATOL outright.
ONE_ATOL = 1e-5
PARAM_ATOL = 2.2 * LR * 2
ONE_BOUNDS = {
    "two_pass": {                 # bound   2x2 step  reordering
        "metrics": 2.0e-5,        # 9.40e-6   9.66e-6
        "cls_out": ONE_ATOL,      # 2.77e-6   1.49e-6
        "mu": 9.8e-4,             # 4.90e-4   4.89e-4
        "nu": ONE_ATOL,           # 4.29e-6   4.19e-6
        "nu_max": 4.2e-3,         # 2.14e-3   2.09e-3
        "param": 5.9e-4,          # 2.95e-4   2.95e-4
        "params past": 20580,     # 10223     10290
        "stats": 4.0e-4,          # 1.62e-4   1.99e-4 (relative to each statistic's size)
    },
    "single_pass": {
        "metrics": 1.1e-5,        # 1.31e-6   5.48e-6
        "cls_out": ONE_ATOL,      # 2.68e-6   2.51e-6
        "mu": 9.7e-5,             # 4.83e-5   4.81e-5
        "nu": ONE_ATOL,           # 7.45e-7   7.47e-7
        "nu_max": 1.5e-3,         # 7.45e-4   7.46e-4
        "param": 4.0e-4,          # 2.00e-4   2.00e-4
        "params past": 616,       # 301       308
        "stats": ONE_ATOL,        # 1.02e-6   7.26e-7
    },
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the steps are many small ops: beside the other test workers, more
    # intra-op threads only wait on each other
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------- shard plan

def _jax_state(jm, cfg, shape):
    """JAX's TrainState of ``jm`` as shapes (nothing is computed)."""
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros(shape),
                                       train=False))
    tx, _ = joptim.build_optimizer(cfg, v["params"])
    return JaxTrainState(step=jax.ShapeDtypeStruct((), jnp.int32), params=v["params"],
                         batch_stats=v["batch_stats"],
                         opt_state=jax.eval_shape(tx.init, v["params"]))


def _torch_dim(path: tuple, spec, shape) -> int:
    """The torch dim that JAX's 'model'-sharded axis becomes through the
    converter's layout (``convert._layout`` of an array counting along that
    axis); None for a replicated leaf."""
    spec = tuple(spec)
    if jmesh.MODEL_AXIS not in spec:
        return None
    axis = spec.index(jmesh.MODEL_AXIS)
    marks = np.arange(shape[axis]).reshape([-1 if i == axis else 1 for i in range(len(shape))])
    t = _layout(path, np.broadcast_to(marks, shape))
    return next(d for d in range(t.ndim) if (np.diff(t, axis=d) != 0).any())


def _jax_plan(state, min_size: int) -> dict:
    """``state_shardings`` of JAX's state on a 4x2 mesh, as the port's plan:
    torch key -> torch dim or None, for the params, the batch statistics
    and each Adam slot; every count checked replicated."""
    sh = jmesh.state_shardings(state, jmesh.create_mesh_2d(4, model_parallel=MP), min_size)

    def plan(tree, shapes):
        specs, leaves = flatten_dict(tree), flatten_dict(shapes)
        return {torch_key(p): _torch_dim(p, s.spec, leaves[p].shape) for p, s in specs.items()}

    out = {"params": plan(sh.params, state.params),
           "buffers": plan(sh.batch_stats, state.batch_stats),
           "slots": {s: plan(getattr(sh.opt_state[0], s), getattr(state.opt_state[0], s))
                     for s in SLOTS}}
    for spec, leaf in zip(jax.tree.leaves(sh.opt_state), jax.tree.leaves(state.opt_state)):
        assert leaf.shape or tuple(spec.spec) == ()  # the counts replicated
    assert tuple(sh.step.spec) == ()
    return out


@pytest.fixture(scope="module")
def states():
    """Each model's JAX TrainState (shapes) and the port's model and
    optimizer state, built once for both min_size cases."""
    b4_cfg = chip_smoke.model_spec("UDEB4")["config"]
    out = {}
    for name, jm, build, cfg, shape in (
            ("UDEB4-b0", UniDefenseModelEb4(extractor="efficientnet-b0",
                                            delimiter=B0_DELIMITER, dtype=jnp.float32),
             lambda: build_model("UDEB4", {"extractor": "efficientnet-b0",
                                           "delimiter": B0_DELIMITER}), b4_cfg, (2, 64, 64, 3)),
            ("UDR18", UniDefenseModelRes18(dtype=jnp.float32), lambda: build_model("UDR18", {}),
             CFG, (2, SIZE, SIZE, 3))):
        net = build()
        out[name] = (_jax_state(jm, cfg, shape), net, toptim.build_optimizer(cfg)[0].init(net))
    return out


@pytest.mark.parametrize("min_size", [1 << 16, 1024])
@pytest.mark.parametrize("model", ["UDEB4-b0", "UDR18"])
def test_shard_plan_matches_jax(states, model, min_size):
    """Leaf for leaf through ``convert.torch_key``: the same leaves sharded,
    on the torch dim that holds JAX's last axis (conv and dense dim 0,
    deconv dim 1), and every BatchNorm statistic replicated; the optimizer
    slots as their parameters. The port's own leaves that JAX lacks (the
    frozen bottleneck bias, ``num_batches_tracked``) are replicated."""
    jax_state, net, opt_state = states[model]
    want = _jax_plan(jax_state, min_size)
    got = tmesh.shard_plan(net, opt_state, MP, min_size)
    assert {k: got["params"][k] for k in want["params"]} == want["params"]
    assert all(got["params"][k] is None for k in set(got["params"]) - set(want["params"]))
    assert {k: got["buffers"][k] for k in want["buffers"]} == want["buffers"]
    assert set(got["buffers"].values()) == {None}
    assert set(got["slots"]) == set(SLOTS)
    for s in SLOTS:
        assert got["slots"][s] == want["slots"][s], s
    sharded = sum(d is not None for d in want["params"].values())
    assert sharded >= (5 if min_size == 1 << 16 else 20), sharded


# ----------------------------------------------------- the sharded gather

def test_sharded_gather_and_backward_match_unsharded(tmp_path):
    """Two ranks (a 1x2 mesh), a Conv2d, a ConvTranspose2d and a Linear
    sharded at min_size 1 on dims 0, 1 and 0: the output, each weight's
    gradient (this rank's slice of the unsharded one, not mp times it),
    the biases' gradients, and the weights and Adam slots after one update
    equal the unsharded layers' bit for bit on both ranks; ``gather_state``
    gives the unsharded state."""
    got = torch_ranks.spawn(torch_ranks.sharded_layers, str(tmp_path), 3, world=2)
    for r, res in enumerate(got):
        assert res["dims"] == {"0.weight": 0, "1.weight": 1, "3.weight": 0}
        assert res["place"] == (0, r)
        for name, equal in res["equal"].items():
            assert equal, f"rank {r}: {name} differs from the unsharded layers"


# --------------------------------------------------------------- the steps

def _draws(key) -> tuple:
    """The global flips and perturbation of JAX's two-pass step with ``key``
    (its key split as step.py:211-216 splits it) and the single-pass
    step's flips (step.py:323-326)."""
    _, _, kp, kpre = jax.random.split(key, 4)
    _, kf = jax.random.split(kpre)
    flip = torch.from_numpy(np.array(jax.random.uniform(kf, (N, 1, 1, 1)) < 0.5).reshape(-1))
    two = StepDraws(flip=flip, perturb=jax_perturb_draws(kp, (N, SIZE, SIZE, 3), SUM_REAL,
                                                         SUM_FAKE))
    _, kpre = jax.random.split(key)
    _, kf = jax.random.split(kpre)
    one = StepDraws(flip=torch.from_numpy(
        np.array(jax.random.uniform(kf, (N, 1, 1, 1)) < 0.5).reshape(-1)))
    return two, one


def _step_key():
    """The first key whose pass-2 input takes the frequency style mix (CORAL,
    the amplitude mix) with a partner across the data ranks for a row of
    data rank 0."""
    for s in range(400):
        key = jax.random.PRNGKey(s)
        d = _draws(key)[0].perturb
        partners = torch.cat([d.perm_real, SUM_REAL + d.perm_fake])
        if _branch(d) == "freq_style" and bool((partners[:N // 2] >= N // 2).any()):
            return key
    raise AssertionError("no key")


def _batch():
    frames = np.random.default_rng(7).integers(0, 256, (N, SIZE, SIZE, 3), dtype=np.uint8)
    return frames, np.array([0] * SUM_REAL + [1] * SUM_FAKE)


# reals among reals, fakes among fakes: the same step on the same batch,
# with other sums
REORDER = np.array([2, 0, 1, 7, 5, 3, 6, 4])


def _reordered(draws) -> tuple:
    """(frames, labels) and the (two-pass, single-pass) draws of the global
    batch with its rows in REORDER's order (new row j is row REORDER[j]):
    the flips, blend factors and noise move with their rows and every row
    keeps its style partner."""
    frames, labels = _batch()
    order = torch.from_numpy(REORDER)
    back = torch.argsort(order)
    two, one = draws
    d = two.perturb
    partners = back[torch.cat([d.perm_real, SUM_REAL + d.perm_fake])[order]]
    perturb = PerturbDraws(style=d.style, perm_real=partners[:SUM_REAL],
                           perm_fake=partners[SUM_REAL:] - SUM_REAL, freq=d.freq,
                           lmda=d.lmda[order], pixel=d.pixel, normal=d.normal[order])
    return ((frames[REORDER], labels[REORDER]),
            (StepDraws(flip=two.flip[order], perturb=perturb), StepDraws(flip=one.flip[order])))


def _jax_step(jm, v, two_pass: bool, key) -> dict:
    """JAX's global-batch step (no axis_name) under gspmd_train_step on a
    4x2 mesh at MIN_SIZE: metrics, cls_out, state_dict and Adam slots in
    the port's names and layouts."""
    tx, _ = joptim.build_optimizer(CFG, v["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    pre = JaxDevicePipeline(hflip_p=0.5)
    step_fn = (jax_make_train_step(jm, tx, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE, preprocess=pre)
               if two_pass else
               jax_make_normal_train_step(jm, tx, CFG, SUM_REAL, SUM_FAKE, preprocess=pre))
    step = jmesh.gspmd_train_step(step_fn, jmesh.create_mesh_2d(4, model_parallel=MP), state,
                                  min_size=MIN_SIZE)
    frames, labels = _batch()
    new, metrics, cls_out = step(state, {"image": frames, "label": labels}, key)
    return {"metrics": {k: float(m) for k, m in metrics.items()}, "cls_out": np.asarray(cls_out),
            "params": state_dict_from_jax({"params": new.params,
                                           "batch_stats": new.batch_stats}),
            "slots": {s: state_dict_from_jax({"params": getattr(new.opt_state[0], s)})
                      for s in SLOTS}}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One run of each step on the port's 2x2 mesh (four gloo ranks), on
    JAX's 4x2 mesh, and in one port process with the synced statistics on
    the batch as it is and reordered (a world of one rank), from the same
    UDR18 weights (drop rates 0, BatchNorm scales and statistics random)
    and the same global draws. The ranks are spawned first, so that they
    run while JAX compiles."""
    jm = UniDefenseModelRes18(drop_rate=0.0, feat_drop_rate=0.0, dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((4, SIZE, SIZE, 3)), train=False)
    v = _scaled(_randomise(v))
    key = _step_key()
    draws = _draws(key)
    sd = state_dict_from_jax(v)
    frames, labels = _batch()
    reordered, reordered_draws = _reordered(draws)
    with module_tmp(tmp_path_factory, "mesh2d") as tmp, futures.ThreadPoolExecutor(2) as pool:
        (tmp / "mesh").mkdir()
        (tmp / "one").mkdir()
        mesh = pool.submit(torch_ranks.spawn, torch_ranks.mesh2d_steps, str(tmp / "mesh"), sd,
                           CFG, NUM_STEPS, frames, labels, list(draws), MP, MIN_SIZE,
                           world=WORLD)
        one = pool.submit(torch_ranks.spawn, torch_ranks.synced_one_process_steps,
                          str(tmp / "one"), sd, CFG, NUM_STEPS, [(frames, labels), reordered],
                          [draws, reordered_draws], world=1)
        with futures.ThreadPoolExecutor(2) as compiles:  # XLA compiles off the GIL
            jax_runs = {name: compiles.submit(_jax_step, jm, v, two, key)
                        for name, two in (("two_pass", True), ("single_pass", False))}
            runs = {name: {"jax": run.result()} for name, run in jax_runs.items()}
        ranks, (one_runs,) = mesh.result(), one.result()
        for name, run in runs.items():
            run["ranks"] = [r[name] for r in ranks]
            run["one"], run["reordered"] = (o[name] for o in one_runs["runs"])
            run["reordered"]["cls_out"] = run["reordered"]["cls_out"][np.argsort(REORDER)]
        runs["places"] = [(r["place"], r["rows"]) for r in ranks]
        runs["drawn"] = {"ranks": [r["drawn"] for r in ranks], "one": one_runs["drawn"]}
        yield runs


STEPS = ["two_pass", "single_pass"]


def test_ranks_hold_their_rows_and_shards(mesh_runs):
    """Rank r*mp + m at data row r, model column m; data row r takes rows
    [4r, 4r + 4) of the global batch; the sharded weights on each rank are
    half their size on the sharded dim."""
    assert mesh_runs["places"] == [((0, 0), (0, 4)), ((0, 1), (0, 4)), ((1, 0), (4, 8)),
                                   ((1, 1), (4, 8))]
    shards = mesh_runs["two_pass"]["ranks"][0]["sharded"]
    full = mesh_runs["two_pass"]["one"]["params"]
    assert len(shards) >= 20
    for name, shape in shards.items():
        assert sum(a != b for a, b in zip(shape, full[name].shape)) == 1, name
        assert np.prod(shape) * MP == full[name].numel(), name


@pytest.mark.parametrize("name", STEPS)
def test_ranks_states_bitwise_equal(mesh_runs, name):
    """Every rank's gathered parameters, buffers and slots (sha256), metrics
    and global cls_out are the same bit for bit."""
    ranks = mesh_runs[name]["ranks"]
    assert len({r["digest"] for r in ranks}) == 1
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"] and r["step"] == ranks[0]["step"] == 1
        assert torch.equal(r["cls_out"], ranks[0]["cls_out"])


@pytest.mark.parametrize("name", STEPS)
def test_step_matches_jax_gspmd(mesh_runs, name):
    """The 2x2 step against JAX's gspmd_train_step on the 4x2 mesh: every
    metric, the parameters and the running statistics at UDR_STEP_TOL
    (test_torch_udr_train: where JAX's own UDR18 step is determined);
    cls_out (global, N x 2) at 1e-3, as the 1-D tests hold it; each Adam
    slot by its norm per tensor at UDR_STEP_TOL's gradient bound (mu is an
    average of gradients), nu and nu_max (of squared gradients) at twice
    it, sf_coef's at its sf_rel."""
    run, tol = mesh_runs[name], UDR_STEP_TOL
    port = run["ranks"][0]
    jax_run = run["jax"]
    assert port["cls_out"].shape == jax_run["cls_out"].shape == (N, 2)
    np.testing.assert_allclose(port["cls_out"].numpy(), jax_run["cls_out"], rtol=1e-3, atol=1e-3)
    assert_step_matches({"jax": _snapshot(jax_run["metrics"], [], jax_run["params"], None),
                         "port": _snapshot(port["metrics"], [], port["params"], None)}, tol)
    for s in SLOTS:
        want, got = jax_run["slots"][s], port["slots"][s]
        # the converter gives the frozen bottleneck bias, which JAX does not train
        assert set(got) == set(want) - {"bottleneck.bias"}
        want = {k: want[k] for k in got}
        total = sum(float(t.norm()) ** 2 for t in want.values()) ** 0.5
        scale = 1 if s == "mu" else 2
        for k, ref in want.items():
            rel = scale * (tol["sf_rel"] if k.endswith("sf_coef") else tol["grad_rel"])
            nj, nt = float(ref.norm()), float(got[k].norm())
            assert abs(nt - nj) <= rel * nj + scale * tol["grad_floor"] * total, \
                f"{s} {k}: |{s}| {nt} vs {nj} (all {total})"


def _gaps(a: dict, b: dict) -> dict:
    """How far run ``a`` is from run ``b``: the largest metric difference,
    cls_out's, each slot's, the parameters' (and how many elements past
    ONE_ATOL) and the running statistics' relative to their size."""
    params = [(a["params"][k].double() - r.double()).abs() for k, r in b["params"].items()
              if r.is_floating_point() and "running" not in k]
    return {"metrics": max(abs(a["metrics"][k] - r) for k, r in b["metrics"].items()),
            "cls_out": float((a["cls_out"] - b["cls_out"]).abs().max()),
            **{s: max(float((a["slots"][s][k] - r).abs().max()) for k, r in b["slots"][s].items())
               for s in SLOTS},
            "param": max(float(d.max()) for d in params),
            "params past": sum(int((d > ONE_ATOL).sum()) for d in params),
            "stats": max(float((a["params"][k] - r).abs().max() / r.abs().max())
                         for k, r in b["params"].items() if "running" in k)}


@pytest.mark.parametrize("name", STEPS)
def test_step_matches_one_process(mesh_runs, name):
    """The 2x2 step against the port's one-process step on the global batch
    with the synced statistics (see ONE_BOUNDS' comment): every gap within
    its ONE_BOUNDS; cls_out within ONE_ATOL; the parameters within
    PARAM_ATOL. The one-process step moves about as far under a reordering
    of its rows."""
    run = mesh_runs[name]
    got = _gaps(run["ranks"][0], run["one"])
    assert got["cls_out"] <= ONE_ATOL and got["param"] <= PARAM_ATOL, got
    assert set(got) == set(ONE_BOUNDS[name])
    for k, bound in ONE_BOUNDS[name].items():
        assert got[k] <= bound, (k, got)
    own = _gaps(run["reordered"], run["one"])
    for k, bound in ONE_BOUNDS[name].items():
        assert own[k] <= bound, ("reordered", k, own)


def test_step_draws_what_one_process_draws(mesh_runs):
    """A two-pass step from a seeded generator at UDR18's default drop rates
    (flips, dropout masks and the perturbation all drawn): each rank of the
    2x2 mesh draws at the global batch's shapes, so the generator's state
    after the step is one process's bit for bit on every rank, and the
    metrics agree as the drawn-in step's do (ONE_BOUNDS' two-pass metrics;
    read on the CPU: 1.73e-6 on every rank)."""
    drawn = mesh_runs["drawn"]
    bound = ONE_BOUNDS["two_pass"]["metrics"]
    for r in drawn["ranks"]:
        assert torch.equal(r["generator"], drawn["one"]["generator"])
        for k, ref in drawn["one"]["metrics"].items():
            assert abs(r["metrics"][k] - ref) <= bound, (k, r["metrics"][k], ref)


# ------------------------------------------------------------------ meshes

def test_create_mesh_2d_refuses_what_jax_refuses(monkeypatch):
    """Three devices at model_parallel 2 raise JAX's ValueError, whether
    asked for or found in the world (WORLD_SIZE), before any world is
    joined."""
    with pytest.raises(ValueError) as jax_err:
        jmesh.create_mesh_2d(3, model_parallel=2)
    with pytest.raises(ValueError) as err:
        tmesh.create_mesh_2d(3, model_parallel=2, device="cpu")
    assert str(err.value) == str(jax_err.value)
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError) as env_err:
        tmesh.create_mesh_2d(model_parallel=2, device="cpu")
    assert str(env_err.value) == str(jax_err.value)
    assert not torch.distributed.is_initialized()


class _Device:
    """A stand-in device for mesh_utils: its id and its host (slice)."""

    platform = device_kind = "cpu"

    def __init__(self, i, host):
        self.id, self.slice_index, self.process_index = i, host, host


def _jax_hybrid_grid(hosts, mp):
    devices = [_Device(i, h) for i, h in enumerate(hosts)]
    per_host = len(hosts) // len(set(hosts))
    grid = mesh_utils.create_hybrid_device_mesh(
        mesh_shape=(per_host // mp, mp), dcn_mesh_shape=(len(set(hosts)), 1), devices=devices)
    return np.vectorize(lambda d: d.id)(grid.reshape(-1, mp))


@pytest.mark.parametrize("hosts", [[0] * 4 + [1] * 4, [0, 1] * 4], ids=["blocks", "interleaved"])
def test_hybrid_rank_grid_keeps_model_rows_on_a_host(hosts):
    """Two hosts x 4 ranks at mp 2: the grid JAX's
    create_hybrid_device_mesh builds (dcn (2, 1), each host a slice) for
    ranks numbered host by host (torchrun's) and for interleaved hosts;
    every 'model' row on one host, 'data' across both."""
    grid = tmesh.hybrid_rank_grid(8, 4, MP, hosts)
    np.testing.assert_array_equal(grid, _jax_hybrid_grid(hosts, MP))
    for row in grid:
        assert len({hosts[r] for r in row}) == 1
    assert {hosts[r] for r in grid[:, 0]} == {0, 1}


def test_hybrid_rank_grid_on_one_host_is_the_2d_grid():
    """One host of 8 (and a host whose 3 ranks mp 2 does not divide): the
    grid of create_mesh_2d, as JAX's create_hybrid_mesh falls back on one
    slice (tests/test_parallel.py:190-197): (4, 2) over the devices in
    order."""
    jax_grid = np.vectorize(lambda d: d.id)(jmesh.create_hybrid_mesh(MP).devices)
    np.testing.assert_array_equal(tmesh.hybrid_rank_grid(8, 8, MP, [0] * 8), jax_grid)
    np.testing.assert_array_equal(tmesh.hybrid_rank_grid(6, 3, MP, [0] * 3 + [1] * 3),
                                  np.arange(6).reshape(3, 2))
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.hybrid_rank_grid(3, 3, MP, [0] * 3)


def test_one_by_one_mesh_is_the_one_process_step():
    """A world of one: create_mesh_2d and create_hybrid_mesh give a 1x1 mesh
    without groups, gspmd_train_step returns the step unchanged and shards
    nothing, and the step with the mesh equals make_train_step's bit for
    bit (UDR18 16^2, 1 + 1, fp32, its default drop rates, one generator
    seed)."""
    mesh = tmesh.create_mesh_2d(device="cpu")
    assert (mesh.dp, mesh.mp, mesh.data_group, mesh.model_group, mesh.mesh) == (1, 1, None, None,
                                                                              None)
    assert tmesh.create_hybrid_mesh(device="cpu").shape == {"data": 1, "model": 1}
    frames = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 16, 16, 3),
                                                                dtype=np.uint8))
    batch = {"image": frames, "label": torch.tensor([0, 1])}
    digests = []
    for use_mesh in (False, True):
        torch.manual_seed(0)
        model = build_model("UDR18", {})  # default drop rates: masks drawn
        tx, _ = toptim.build_optimizer(CFG)
        state = create_train_state(model, tx, device="cpu")
        step = make_train_step(tx, CFG, NUM_STEPS, 1, 1, preprocess=DevicePipeline(hflip_p=0.5),
                               mesh=mesh if use_mesh else None)
        if use_mesh:
            assert tmesh.gspmd_train_step(step, mesh, state) is step
            assert getattr(model, "sharded", None) is None
        gen = torch.Generator().manual_seed(1)
        _, metrics, cls_out = step(state, batch, gen)
        digests.append((torch_ranks.state_digest(state), {k: float(m) for k, m in metrics.items()},
                        cls_out.numpy().tobytes(), gen.get_state().numpy().tobytes()))
    assert digests[0] == digests[1]


def test_batch_rows_draw_the_global_batch():
    """A BatchRows generator's draws (the device stage's flips, dropout and
    drop-connect masks) are rows of one process's draws for the global
    batch, and it hands the generator's advanced state back."""
    gen = torch.Generator().manual_seed(4)
    want = torch.rand(8, 3, generator=gen)
    for start in (0, 4):
        rows = tmesh.batch_rows(torch.Generator().manual_seed(4), 8, slice(start, start + 4))
        got = tmesh.batch_draw(torch.rand, (4, 3), rows)
        assert torch.equal(got, want[start:start + 4])
        assert torch.equal(rows.get_state(), gen.get_state())
    plain = torch.Generator().manual_seed(4)
    assert tmesh.batch_rows(plain, 8, slice(0, 8)) is plain
    with pytest.raises(ValueError, match="rows"):
        tmesh.batch_draw(torch.rand, (3,), tmesh.batch_rows(plain, 8, slice(0, 4)))


def test_perturbation_takes_partners_across_ranks():
    """perturb_input on rows 4:8 of the global batch equals rows 4:8 of the
    one-process perturbation: the frequency style mix with the global batch
    as the partners' source, the noise without one."""
    from unidefense_torch.train.perturb import perturb_input

    x = torch.rand(N, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    d = PerturbDraws.draw(torch.Generator().manual_seed(5), SUM_REAL, SUM_FAKE, tuple(x.shape))
    for style, pixel in ((True, 0), (False, 0)):
        dd = PerturbDraws(**{**d.__dict__, "style": style, "freq": True, "pixel": pixel})
        whole = perturb_input(x, SUM_REAL, SUM_FAKE, draws=dd)
        part = perturb_input(x[4:], SUM_REAL, SUM_FAKE, draws=dd, source=x if style else None,
                             rows=slice(4, 8))
        torch.testing.assert_close(part, whole[4:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("model", ["UDEB4-b0", "UDR18"])
def test_global_outputs_refuse_a_loss_they_do_not_gather(states, model):
    """With more than one data rank, a loss_dict entry the 2-D mode does not
    gather over 'data' (a loss a model reduced over its own rows, such as
    the single-pass step's aux_cls_loss) raises before any collective; the
    entries it gathers are all that the models emit (Eb4's forward and the
    ResNets')."""
    from unidefense_torch.train import step as tstep

    mesh = tmesh.Mesh2D(dp=2, data_group=object())
    cls_out = torch.zeros(4, 2)
    for key in ("aux_cls_loss", "aux_spatial", "aux_freq"):
        with pytest.raises(NotImplementedError, match=key):
            tstep._global_outputs({"cls_out": cls_out, "loss_dict": {key: cls_out}}, mesh)
    net = states[model][1]
    size = 64 if model == "UDEB4-b0" else SIZE
    with torch.no_grad():
        out = net.eval()(torch.zeros(2, 3, size, size))
    assert set(out["loss_dict"]) == set(tstep._GATHERED)
