"""Rank functions that tests/test_torch_parallel.py and
tests/test_torch_multiproc.py spawn through ``parallel.launch`` on the CPU
(gloo). Each joins the world, runs the port's data-parallel path and saves
what the test compares into ``<out>/rank<r>.pt``. This module imports only
torch and the port: the ranks start without JAX."""

from __future__ import annotations

import hashlib
import os
import sys

import torch

from unidefense_torch.models import layers as tl
from unidefense_torch.parallel import all_gather_objects, init_data_parallel, sync_batchnorm
from unidefense_torch.train import optim as toptim


def spawn(fn, out: str, *args, world: int = 2, timeout: float = 240.0) -> list:
    """``fn(out, *args)`` on ``world`` gloo ranks; every rank's saved result."""
    from unidefense_torch.parallel import launch

    launch(fn, world, args=(out, *args), device="cpu", timeout=timeout)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _join():
    torch.set_num_threads(1)
    return init_data_parallel(device="cpu")


def _save(out: str, dp, result) -> None:
    torch.save(result, os.path.join(out, f"rank{dp.rank}.pt"))


def digest(tensors) -> str:
    """sha256 of the bytes of ``tensors`` in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def state_digest(state) -> str:
    """Of the model's state_dict and the optimizer's slots, in order."""
    opt = state.opt_state
    return digest(list(state.model.state_dict().values()) + opt.tensors())


# ------------------------------------------------------------ parallel layer

def gather_ragged(out: str) -> None:
    dp = _join()
    got = all_gather_objects({f"videos_{dp.rank}": list(range(dp.rank * 3 + 1))}, dp.rank * 10,
                             group=dp.group)
    _save(out, dp, got)


def batchnorm(out: str, xs, cs, state_dict, momentum: float, eps: float) -> None:
    """One train-mode forward and backward of a synced BatchNorm on this
    rank's half ``xs[rank]``, loss sum(y * cs[rank])."""
    dp = _join()
    bn = tl.BatchNorm(xs[0].shape[1], eps=eps, momentum=momentum).train()
    bn.load_state_dict(state_dict, strict=True)
    sync_batchnorm(bn, dp.group)
    x = torch.from_numpy(xs[dp.rank]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(cs[dp.rank])).sum().backward()
    _save(out, dp, {"y": y.detach(), "mean": bn.running_mean.clone(),
                    "var": bn.running_var.clone(), "dx": x.grad, "dw": bn.weight.grad,
                    "db": bn.bias.grad})


class RecordingAdam(toptim.Adam):
    """The port's optimizer, keeping the gradients of its last two updates
    (test_torch_train.RecordingAdam)."""

    def update(self, model, state, lr_scale=None):
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}
        self.seen = (getattr(self, "seen", [])[-1:]) + [grads]
        super().update(model, state, lr_scale)


def train_steps(out: str, state_dict, cfg: dict, num_steps: int, batches, draws,
                two_pass: bool = True) -> None:
    """UDR18 (drop rates 0) from ``state_dict``, the two-pass (or the
    single-pass) step across the ranks; step i takes this rank's
    ``batches[rank]`` and ``draws[i][rank]``. Saves a snapshot after every
    step: metrics, the gradients of the step's updates, the state_dict,
    cls_out and the state's digest."""
    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.train.step import (
        create_train_state, make_normal_train_step, make_train_step)

    dp = _join()
    model = build_model("UDR18", {"drop_rate": 0.0, "feat_drop_rate": 0.0})
    model.load_state_dict(state_dict, strict=True)
    sync_batchnorm(model, dp.group)
    tx = RecordingAdam(**toptim.build_optimizer(cfg)[0].__dict__)
    state = create_train_state(model, tx, device="cpu")
    frames, labels = batches[dp.rank]
    n_real = int((labels == 0).sum())
    if two_pass:
        step = make_train_step(tx, cfg, num_steps, n_real, len(labels) - n_real,
                               preprocess=DevicePipeline(hflip_p=0.5), group=dp.group)
    else:
        step = make_normal_train_step(tx, cfg, n_real, len(labels) - n_real,
                                      preprocess=DevicePipeline(hflip_p=0.5), group=dp.group)
    snaps = []
    for per_rank in draws:
        state, metrics, cls_out = step(state, {"image": torch.from_numpy(frames),
                                               "label": torch.from_numpy(labels)},
                                       None, per_rank[dp.rank])
        snaps.append({"step": state.step, "metrics": {k: float(v) for k, v in metrics.items()},
                      "grads": list(tx.seen),
                      "params": {k: v.clone() for k, v in state.model.state_dict().items()},
                      "cls_out": cls_out.clone(), "digest": state_digest(state)})
    _save(out, dp, snaps)


# -------------------------------------------------------------------- engines

def engine_run(out: str, work: str, argv: list, preempt_rank=None, record_val: bool = False):
    """``unidefense_torch.main.run(argv, "cpu")`` (what ``main`` spawns) in
    ``work``. ``preempt_rank`` sets the preemption flag on that rank alone at
    step 1. Saves the state's digest right after the engine is built (the
    restored state on a resume) and after the run, the step, every best_*
    metric, the samplers' shards and first epoch, and with ``record_val``
    the merged output of each gather_eval_output."""
    from unidefense_torch.engines import base
    from unidefense_torch.main import run

    torch.set_num_threads(1)
    os.chdir(work)
    stdout = sys.stdout
    built, merged = {}, []
    init, gather = base.AbstractEngine.__init__, base.AbstractEngine.gather_eval_output

    def init_and_record(engine, *args, **kwargs):
        init(engine, *args, **kwargs)
        built["digest"] = state_digest(engine.state)
        if preempt_rank is not None and engine.dp.rank == preempt_rank:
            tick = engine._profile_tick

            def tick_and_flag(cur_step):
                if cur_step == 1:
                    engine._preempt_requested = True
                tick(cur_step)
            engine._profile_tick = tick_and_flag

    def gather_and_record(engine, prob_dict, tgt_dict):
        result = gather(engine, prob_dict, tgt_dict)
        if record_val:
            merged.append(result)
        return result

    base.AbstractEngine.__init__ = init_and_record
    base.AbstractEngine.gather_eval_output = gather_and_record
    try:
        engine = run(argv, "cpu")
    finally:
        base.AbstractEngine.__init__, base.AbstractEngine.gather_eval_output = init, gather
        sys.stdout = stdout
    samplers = [b.sampler for b in engine._batchers()]
    first_epoch = []
    for s in samplers:
        s.set_epoch(0)
        first_epoch.append([b.tolist() for b in s])
    _save(out, engine.dp, {
        "built": built["digest"], "digest": state_digest(engine.state), "step": engine.state.step,
        "best": {k: float(v) for k, v in vars(engine).items() if k.startswith("best_")},
        "shards": [dict(shard_id=s.shard_id, num_shards=s.num_shards, batch_size=s.batch_size,
                        dataset_len=s.dataset_len, drop_last=s.drop_last, pad_last=s.pad_last)
                   for s in samplers],
        "first_epoch": first_epoch, "merged": merged, "run_dir": engine.run_dir,
        "rank": engine.dp.rank, "world": engine.n_dev})


def fail_on_rank_one(out: str) -> None:
    """Rank 1 raises; rank 0 waits at a barrier for it."""
    dp = _join()
    if dp.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier(group=dp.group)
    _save(out, dp, "unreachable")


# ------------------------------------------------------------- train config

def broadcast_states(out: str) -> None:
    """A small model and an ASGD and an AdamW-amsgrad state that differ per
    rank, two updates each, then ``broadcast_state``: saves each
    optimizer's state digest before and after."""
    from unidefense_torch.parallel import broadcast_state

    dp = _join()
    result = {}
    for name, opt in (("asgd", {"name": "asgd", "lr": 0.01, "t0": 0}),
                      ("adamw", {"name": "adamw", "lr": 0.01, "amsgrad": True})):
        gen = torch.Generator().manual_seed(dp.rank)
        model = torch.nn.Linear(3, 4)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        tx, _ = toptim.build_optimizer({"optimizer": opt})
        opt_state = tx.init(model)
        for _ in range(2):
            for p in model.parameters():
                p.grad = torch.randn(p.shape, generator=gen)
            tx.update(model, opt_state)
        state = type("S", (), {"model": model, "opt_state": opt_state})()
        before = state_digest(state)
        broadcast_state(model, opt_state, dp.group)
        result[name] = (before, state_digest(state))
    _save(out, dp, result)


def remat_steps(out: str, state_dict, halves) -> None:
    """UDR18 from ``state_dict`` with synced BatchNorm, two two-pass steps
    (sgd momentum) on this rank's half from one generator seed, without and
    then with remat; saves both state_dicts and the second's digest."""
    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.train.step import create_train_state, make_train_step

    dp = _join()
    cfg = {"optimizer": {"name": "sgd", "lr": 0.01, "momentum": 0.9}}
    result = {}
    for remat in (False, True):
        model = build_model("UDR18", {}, remat=remat)
        model.load_state_dict(state_dict, strict=True)
        sync_batchnorm(model, dp.group)
        tx, _ = toptim.build_optimizer(cfg)
        state = create_train_state(model, tx, device="cpu")
        step = make_train_step(tx, cfg, 20, 1, 1, preprocess=DevicePipeline(hflip_p=0.5),
                               group=dp.group)
        gen = torch.Generator().manual_seed(5 + dp.rank)
        batch = {"image": torch.from_numpy(halves[dp.rank]), "label": torch.tensor([0, 1])}
        for _ in range(2):
            step(state, batch, gen)
        result["remat" if remat else "plain"] = {k: v.clone()
                                                 for k, v in model.state_dict().items()}
        result["digest"] = state_digest(state)
    _save(out, dp, result)


# ------------------------------------------------------------------ 2-D mode

def mesh2d_steps(out: str, state_dict, cfg: dict, num_steps: int, frames, labels, draws,
                 model_parallel: int, min_size: int) -> None:
    """UDR18 (drop rates 0) from ``state_dict`` on a ('data', 'model') mesh
    of the world's ranks: the two-pass step, then the single-pass step from
    the same weights, each once on this rank's rows of the global batch
    (``frames``, ``labels``) with the global ``draws`` (two-pass, then
    single-pass). Saves, per step, the metrics, the global cls_out, the
    gathered state_dict and slots, their digest, this rank's place and the
    names and shapes it keeps sharded; the state itself on rank 0 only (the
    ranks' digests show the others equal)."""
    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.parallel.mesh import create_mesh_2d, gather_state, gspmd_train_step
    from unidefense_torch.train.step import (
        create_train_state, make_normal_train_step, make_train_step)

    torch.set_num_threads(1)
    mesh = create_mesh_2d(None, model_parallel=model_parallel, device="cpu")
    n, n_real = len(labels), int((labels == 0).sum())
    rows = mesh.rows(n)
    batch = {"image": torch.from_numpy(frames[rows]), "label": torch.from_numpy(labels[rows])}
    result = {"place": (mesh.data_index, mesh.model_index), "rows": (rows.start, rows.stop)}
    for name, build, step_draws in (
            ("two_pass", lambda tx: make_train_step(
                tx, cfg, num_steps, n_real, n - n_real, preprocess=DevicePipeline(hflip_p=0.5),
                mesh=mesh), draws[0]),
            ("single_pass", lambda tx: make_normal_train_step(
                tx, cfg, n_real, n - n_real, preprocess=DevicePipeline(hflip_p=0.5),
                mesh=mesh), draws[1])):
        model = build_model("UDR18", {"drop_rate": 0.0, "feat_drop_rate": 0.0})
        model.load_state_dict(state_dict, strict=True)
        tx, _ = toptim.build_optimizer(cfg)
        state = create_train_state(model, tx, device="cpu")
        step = gspmd_train_step(build(tx), mesh, state, min_size)
        state, metrics, cls_out = step(state, batch, None, step_draws)
        sd, slots = gather_state(state.model, state.opt_state, mesh)
        result[name] = {
            "step": state.step, "metrics": {k: float(v) for k, v in metrics.items()},
            "cls_out": cls_out.clone(), "params": sd if mesh.rank == 0 else None,
            "slots": slots if mesh.rank == 0 else None,
            "digest": digest(list(sd.values()) + [t for s in slots.values() for t in s.values()]),
            "sharded": {k: tuple(p.shape) for k, p in state.model.named_parameters()
                        if getattr(state.model, "sharded", None)
                        and state.model.sharded.plan["params"][k] is not None}}
    result["drawn"] = _drawn_step(cfg, num_steps, state_dict, batch, n_real, n - n_real, mesh)
    _save(out, mesh, result)


GENERATOR_SEED = 11


def _drawn_step(cfg: dict, num_steps: int, state_dict, batch: dict, n_real: int, n_fake: int,
                mesh=None) -> dict:
    """One two-pass step of UDR18 at its default drop rates from a seeded
    generator (flips, dropout masks, perturbation all drawn), with ``mesh``
    on this rank's rows or on the whole batch: its metrics and the
    generator's state after it."""
    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.parallel.mesh import gspmd_train_step
    from unidefense_torch.train.step import create_train_state, make_train_step

    model = build_model("UDR18", {})
    model.load_state_dict(state_dict, strict=True)
    tx, _ = toptim.build_optimizer(cfg)
    state = create_train_state(model, tx, device="cpu")
    step = make_train_step(tx, cfg, num_steps, n_real, n_fake,
                           preprocess=DevicePipeline(hflip_p=0.5), mesh=mesh)
    if mesh is not None:
        step = gspmd_train_step(step, mesh, state, 1 << 16)
    gen = torch.Generator().manual_seed(GENERATOR_SEED)
    _, metrics, _ = step(state, batch, gen)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "generator": gen.get_state()}


def sharded_layers(out: str, seed: int) -> None:
    """A Conv2d, a ConvTranspose2d and a Linear sharded over a 1xN mesh of
    the world's ranks at min_size 1, against an unsharded copy in this
    process: one forward, backward and Adam (amsgrad) update each. Saves
    the sharded dims, this rank's place and whether each compared tensor
    is equal bit for bit."""
    import copy

    from unidefense_torch.parallel.mesh import create_mesh_2d, gather_state, shard_state

    torch.set_num_threads(1)
    mesh = create_mesh_2d(None, model_parallel=int(os.environ["WORLD_SIZE"]), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Conv2d(4, 8, 3, padding=1),
                              torch.nn.ConvTranspose2d(8, 6, 3, 2, 1, 1), torch.nn.Flatten(),
                              torch.nn.Linear(6 * 8 * 8, 10))
    ref = copy.deepcopy(net)
    tx = toptim.Adam(lambda count: 1e-3, amsgrad=True)
    opt, ref_opt = tx.init(net), tx.init(ref)
    sharded = shard_state(net, opt, mesh, min_size=1)
    x = torch.randn(3, 4, 4, 4, generator=gen)
    c = torch.randn(3, 10, generator=gen)
    outputs = []
    for m, o in ((net, opt), (ref, ref_opt)):
        y = m(x)
        (y * c).sum().backward()
        tx.update(m, o)
        outputs.append(y.detach())
    sharded.release()
    dims = {k: d for k, d in sharded.plan["params"].items() if d is not None}
    equal = {"output": torch.equal(*outputs)}
    for name, p in net.named_parameters():
        full = dict(ref.named_parameters())[name]
        d = dims.get(name)
        size = p.shape[d] if d is not None else None

        def local(t):
            return t if d is None else t.narrow(d, mesh.model_index * size, size)
        equal[f"{name} grad"] = torch.equal(p.grad, local(full.grad))
        equal[f"{name} updated"] = torch.equal(p.detach(), local(full.detach()))
        for s in opt.slots:
            equal[f"{name} {s}"] = torch.equal(opt.slots[s][name], local(ref_opt.slots[s][name]))
    sd, slots = gather_state(net, opt, mesh)
    equal["gather_state"] = all(torch.equal(sd[k], v) for k, v in ref.state_dict().items()) and \
        all(torch.equal(slots[s][k], v) for s in slots for k, v in ref_opt.slots[s].items())
    _save(out, mesh, {"dims": dims, "place": (mesh.data_index, mesh.model_index),
                      "equal": equal})


def synced_one_process_steps(out: str, state_dict, cfg: dict, num_steps: int, batches,
                             draws) -> None:
    """The port's one-process steps (the two-pass, then the single-pass) on
    each of ``batches`` ((frames, labels), global) with its ``draws`` (a
    (two-pass, single-pass) pair per batch), in a world of this one rank
    with the BatchNorms synced over it: the statistics from the sums E[x]
    and E[x^2] that every data rank of the 2-D mode computes. Saves each
    step's metrics, cls_out, state_dict and slots."""
    import torch.distributed as dist

    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.train.step import (
        create_train_state, make_normal_train_step, make_train_step)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", world_size=1, rank=0)
    results = []
    for (frames, labels), pair in zip(batches, draws):
        n_real = int((labels == 0).sum())
        runs = {}
        for name, step_draws in zip(("two_pass", "single_pass"), pair):
            model = build_model("UDR18", {"drop_rate": 0.0, "feat_drop_rate": 0.0})
            model.load_state_dict(state_dict, strict=True)
            sync_batchnorm(model, dist.group.WORLD)
            tx, _ = toptim.build_optimizer(cfg)
            state = create_train_state(model, tx, device="cpu")
            pre = DevicePipeline(hflip_p=0.5)
            step = (make_train_step(tx, cfg, num_steps, n_real, len(labels) - n_real,
                                    preprocess=pre) if name == "two_pass" else
                    make_normal_train_step(tx, cfg, n_real, len(labels) - n_real,
                                           preprocess=pre))
            state, metrics, cls_out = step(state, {"image": torch.from_numpy(frames),
                                                   "label": torch.from_numpy(labels)}, None,
                                           step_draws)
            runs[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                          "cls_out": cls_out.clone(), "params": state.model.state_dict(),
                          "slots": state.opt_state.slots}
        results.append(runs)
    frames, labels = batches[0]
    n_real = int((labels == 0).sum())
    drawn = _drawn_step(cfg, num_steps, state_dict, {"image": torch.from_numpy(frames),
                                                     "label": torch.from_numpy(labels)},
                        n_real, len(labels) - n_real)
    torch.save({"runs": results, "drawn": drawn}, os.path.join(out, "rank0.pt"))
