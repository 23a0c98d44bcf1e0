"""Training cells: the program's two-pass step (``train/step.make_train_step``
with ``DevicePipeline``'s K1 as its preprocessing) on seeded uint8 frames
resident on the card, one rank per card.

A run, on each rank:

1. set-up: the weights made on the card from the seed (``weights``), the
   program's model built on the ``meta`` device and loaded with them, its
   optimizer state, the step; the step counter at ``start_step`` (past 10%
   of ``num_steps``, so that pass 2 takes the KL branch); a pool of
   ``pool_batches`` batches of frames from the seed (rank r's own);
2. the first ``check_steps`` steps, through the window's own call and feed,
   each on another batch of the pool, with each step's loss, the optimizer's
   first moment after step 1 and the parameters after the last kept on the
   host; then ``warmup_steps`` more;
3. the window: steps until ``--seconds`` have passed, the images of every
   step over the window's seconds; on four cards the ranks agree on the
   last step through a flag they all-reduce a step later;
4. with ``--trace 1``: ``trace_steps`` more under the profiler (rank 0);
5. the program freed, the reference (``reference/train.py``) follows the
   first steps from the same weights, frames and generators, and the gaps
   are compared with the workload's ``limits``.

Step k of rank r draws from its own generator, seeded from (seed, "step",
k, r), as the engines seed a step's.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Optional

import torch

from perfbench import harness, roofline, weights
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.reference.numerics import Numerics
from perfbench.trace import SPAN_PREFIX, profile_window

LEAF_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dtype(cfg: dict):
    return torch.bfloat16 if cfg["config"].get("precision") == "bf16" else None


def pool(seed: int, rank: int, wl: dict, cfg: dict, dev) -> torch.Tensor:
    n = wl["real_per_rank"] + wl["fake_per_rank"]
    size = cfg["data"]["input_size"]
    return weights.frames(wl["pool_batches"] * n, size,
                          weights.generator(seed, dev, "frames", rank), dev)


def batch_rows(wl: dict, k: int) -> slice:
    n = wl["real_per_rank"] + wl["fake_per_rank"]
    b = k % wl["pool_batches"]
    return slice(b * n, (b + 1) * n)


def build_program(cfg: dict, wl: dict, sd: dict, dev, group=None):
    """(state, step): the program's model, optimizer state and two-pass
    step, as the configuration states them."""
    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.parallel.mesh import sync_batchnorm
    from unidefense_torch.train.optim import build_optimizer
    from unidefense_torch.train.step import create_train_state, make_train_step

    model_cfg = {k: v for k, v in cfg["model"].items() if k != "name"}
    with torch.device("meta"):
        net = build_model(cfg["model"]["name"], model_cfg, dtype=_dtype(cfg), v4_widths=())
    net = net.to_empty(device=dev)
    net.load_state_dict(sd, strict=True)
    if group is not None:
        sync_batchnorm(net, group)
    tx, _ = build_optimizer(cfg["config"])
    state = create_train_state(net, tx, device=dev)
    state.step = wl["start_step"]
    data = cfg["data"]
    pipe = DevicePipeline(mean=tuple(data["mean"]), std=tuple(data["std"]),
                          hflip_p=data["hflip_p"])
    step = make_train_step(tx, cfg["config"], data["num_steps"], wl["real_per_rank"],
                           wl["fake_per_rank"],
                           faithful_grad_accumulation=cfg["config"]["faithful_grad_accumulation"],
                           preprocess=pipe, group=group)
    return state, step


class Feed:
    """The step's call and feed, the same in the first steps, the window and
    the traced steps: batch k of the pool and generator k of this rank."""

    def __init__(self, step, state, frames, wl: dict, seed: int, rank: int, dev):
        self.step, self.state, self.frames, self.wl = step, state, frames, wl
        self.seed, self.rank, self.dev = seed, rank, dev
        n_real, n_fake = wl["real_per_rank"], wl["fake_per_rank"]
        self.labels = torch.tensor([0] * n_real + [1] * n_fake, device=dev)
        self.k = 0

    def __call__(self):
        with torch.profiler.record_function(SPAN_PREFIX + "stage"):
            batch = {"image": self.frames[batch_rows(self.wl, self.k)], "label": self.labels}
            gen = weights.generator(self.seed, self.dev, "step", self.k, self.rank)
        with torch.profiler.record_function(SPAN_PREFIX + "step"):
            _, metrics, logits = self.step(self.state, batch, gen)
        self.k += 1
        return metrics, logits


def first_steps(feed: Feed, n: int, keep: bool, phases=None) -> dict:
    """The first ``n`` steps; with ``keep`` each step's loss, step 1's pass-1
    logits, the first moment after step 1 and the parameters after step n,
    on the host."""
    out = {"losses": []}
    for k in range(n):
        metrics, logits = feed()
        out["losses"].append(metrics["total_loss"])
        if keep and k == 0:
            out["logits"] = logits.float().cpu()
            out["mu"] = {name: t.detach().to("cpu", copy=True) for name, t in
                         feed.state.opt_state.slots["mu"].items()}
        if phases is not None and k == 0:
            sync(feed.dev)
            phases.mark("step 1 (kernels built or loaded, first plans, a host copy)")
    out["losses"] = [float(v) for v in out["losses"]]
    if keep:
        out["theta"] = {name: p.detach().to("cpu", copy=True) for name, p in
                        feed.state.model.named_parameters() if p.requires_grad}
    return out


def window(feed: Feed, seconds: float, group=None) -> tuple:
    """(steps, seconds): steps until ``seconds`` have passed, the last one
    finished. With a group, every rank stops after the same step: each step
    all-reduces its rank's "time is up" and the ranks read it a step later,
    when it has long arrived."""
    flags = []
    steps = 0
    sync(feed.dev)
    t0 = time.perf_counter()
    while True:
        feed()
        steps += 1
        late = time.perf_counter() - t0 >= seconds
        if group is None:
            if late:
                break
            continue
        import torch.distributed as dist

        flag = torch.tensor([1.0 if late else 0.0], device=feed.dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        flags.append(flag)
        if len(flags) >= 2 and flags[-2].item() > 0:
            break
    sync(feed.dev)
    return steps, time.perf_counter() - t0


def run_rank(rank: int, wl: dict, cfg: dict, seed: int, seconds: float, trace: bool, dev,
             t_start: float, group=None) -> dict:
    """Everything of one rank up to the program's end; rank 0 keeps the
    first steps' readings; traced, every rank its profile."""
    phases = harness.Phases(t_start)
    if dev.type == "cuda":
        torch.cuda.init()
    phases.mark("start, imports and the CUDA context")
    sd = weights.make_state_dict(cfg, seed, dev)
    sync(dev)
    phases.mark("weights")
    state, step = build_program(cfg, wl, sd, dev, group)
    del sd
    sync(dev)
    phases.mark("program built")
    feed = Feed(step, state, pool(seed, rank, wl, cfg, dev), wl, seed, rank, dev)
    sync(dev)
    phases.mark("frames")
    first = first_steps(feed, wl["check_steps"], keep=rank == 0, phases=phases)
    phases.mark(f"steps 2-{wl['check_steps']} and a host copy")
    for _ in range(wl["warmup_steps"]):
        feed()
    sync(dev)
    phases.mark("warm-up steps")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_start
    steps, secs = window(feed, seconds, group)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    phases.mark("window")
    out = {"first": first, "steps": steps, "seconds": secs, "setup_s": setup_s, "peak": peak,
           "phases": phases.parts}
    if trace:
        def traced():
            for _ in range(wl["trace_steps"]):
                feed()
            return wl["trace_steps"]

        if dev.type == "cuda":
            out["trace"] = profile_window(traced, dev)
        else:
            traced()
    return out


# --------------------------------------------------------------- reference

def reference_steps(cfg: dict, wl: dict, seed: int, dev, nx: Numerics,
                    fault: Optional[str] = None) -> dict:
    """The reference's first ``check_steps`` steps on every rank's batches
    at once, from the same weights, frames and generators. ``fault``, for
    the control's readings: "half" takes every loss over half of each
    rank's reals and fakes, "unchanged" makes every update change
    nothing."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        sd = weights.make_state_dict(cfg, seed, dev)
        model = ref_model.build(cfg["model"], nx, sd, dev)
        model.set_recompute(True)
        theta0 = dict(sd)
        del sd
        opt = ref_train.build_optimizer(model, cfg["config"])
        opt.frozen = fault == "unchanged"
        rows_kept = wl["real_per_rank"] // 2 if fault == "half" else None
        ranks = wl["chips"]
        pools = [pool(seed, r, wl, cfg, dev) for r in range(ranks)]
        out = {"losses": []}
        for k in range(wl["check_steps"]):
            images = torch.cat([p[batch_rows(wl, k)] for p in pools])
            gens = [weights.generator(seed, dev, "step", k, r) for r in range(ranks)]
            got = ref_train.two_pass_step(
                model, opt, images, gens, wl["real_per_rank"], wl["fake_per_rank"],
                wl["start_step"] + k + 1, cfg["config"], cfg["data"]["num_steps"],
                cfg["data"]["hflip_p"], rows_kept)
            out["losses"].append(got["total_loss"])
            if k == 0:
                out["mu"] = {n: t.clone() for n, t in opt.mu.items()}
                out["logits"] = got["logits"]
        out["theta"] = {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}
        out["theta0"] = theta0
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def gaps(got: dict, ref: dict, worst: int = 0) -> dict:
    """The compared numbers of a program's (or the control's) first steps
    against the reference's: ``logit_gap``, the widest gap of step 1's
    pass-1 logits (rank 0's) over the reference's root mean square;
    ``loss_gap``, the largest relative gap of a step's loss; ``grad_gap``,
    the worst leaf's gap between the norms of the optimizer's first moment
    after step 1 (the first gradients as the optimizer got them), over the
    larger of that leaf's reference norm and the median leaf's, and
    ``grad_gap_median``, the median leaf's; ``change_gap`` and
    ``change_gap_median``, the same of the parameters' change over the
    steps. Leaves whose reference gradient is under ``LEAF_FLOOR``
    of the median leaf's are left out of both: their gradient is nought but
    for round-off (a bias that a train-mode BatchNorm or InstanceNorm takes
    out again), and Adam moves them by round-off alone. ``worst``: also a
    look at what the numbers read: each step's loss gap and the ``worst``
    leaves of each (name, gap, norm, reference norm)."""
    dev = next(iter(ref["theta"].values())).device
    steps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    mu_ref = {n: float(t.double().norm()) for n, t in ref["mu"].items()}
    floor = LEAF_FLOOR * ref_train.median(mu_ref.values())
    kept = [n for n, b in mu_ref.items() if b >= floor]
    mu_ref = {n: mu_ref[n] for n in kept}
    mu_got = {n: float(got["mu"][n].to(dev).double().norm()) for n in kept}
    d_ref = {n: float((ref["theta"][n] - ref["theta0"][n]).double().norm()) for n in kept}
    d_got = {n: float((got["theta"][n].to(dev) - ref["theta0"][n]).double().norm())
             for n in kept}
    want = ref["logits"].double()
    logit = float((got["logits"].to(dev).double() - want).abs().max() / want.pow(2).mean().sqrt())
    out = {"logit_gap": logit, "loss_gap": max(steps)}
    looks = {"loss_gaps": steps, "leaves_left_out": len(ref["mu"]) - len(kept)}
    for key, a, b in (("grad_gap", mu_got, mu_ref), ("change_gap", d_got, d_ref)):
        med = ref_train.median(b.values())
        leaf = sorted(((abs(a[n] - b[n]) / max(b[n], med), n) for n in b), reverse=True)
        out[key] = leaf[0][0]
        out[key + "_median"] = ref_train.median(g for g, _ in leaf)
        looks[key] = [(n, g, a[n], b[n]) for g, n in leaf[:worst]]
    if worst:
        out["look"] = looks
    return out


def records(cfg: dict, wl: dict, rank0: dict, chips: int) -> dict:
    """What the per-layer readers take."""
    n = wl["real_per_rank"] + wl["fake_per_rank"]
    work = roofline.model_work(cfg["model"], n, cfg["data"]["input_size"])
    k2, k2bwd = roofline.sfconv_bounds(work["sfconvs"], n, train=True)
    return {"kind": "train", "chips": chips, "trace": rank0.get("trace") or {},
            "window": {"steps": rank0["steps"], "seconds": rank0["seconds"]},
            "flops_per_unit": 6 * work["flops"], "peak_flops": harness.PEAK_BF16_FLOPS,
            "k2_bound_ms_per_unit": k2, "k2bwd_bound_ms_per_unit": k2bwd}


def rank_entry(cell, wl, cfg, seed, seconds, trace, t_start, out_dir, device):
    """One spawned rank of a multi-card cell: joins the world, runs, and
    leaves its readings in ``out_dir``."""
    from unidefense_torch.parallel.mesh import init_data_parallel

    harness.set_cache_dirs()
    dp = init_data_parallel(wl["chips"], device=device)
    got = run_rank(dp.rank, wl, cfg, seed, seconds, trace, dp.device, t_start, dp.group)
    torch.save(got, os.path.join(out_dir, f"rank{dp.rank}.pt"))


def run(cell: str, wl: dict, cfg: dict, seed: int, seconds: float, trace: bool, dev,
        t_start: float, entry=rank_entry) -> dict:
    """One run of a training cell; returns the result line's parts. On more
    than one card the ranks run ``entry`` (the tests plant faults there)."""
    chips = wl["chips"]
    if chips == 1:
        ranks = [run_rank(0, wl, cfg, seed, seconds, trace, dev, t_start)]
    else:
        from unidefense_torch.parallel.mesh import launch

        with tempfile.TemporaryDirectory() as tmp:
            args = (cell, wl, cfg, seed, seconds, trace, t_start, tmp, dev.type)
            launch(entry, chips, args=args, device=dev.type)
            ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                     for r in range(chips)]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r0 = ranks[0]
    steps = r0["steps"]
    images = steps * (wl["real_per_rank"] + wl["fake_per_rank"]) * chips
    e2e = {"train_img_per_s": images / r0["seconds"],
           "setup_s": max(r["setup_s"] for r in ranks)}
    ref = reference_steps(cfg, wl, seed, dev, Numerics())
    numbers = gaps(r0["first"], ref)
    del ref
    out = {"e2e": e2e, "attempted": steps, "failed": 0, "numbers": numbers,
           "peak": max(r["peak"] for r in ranks), "phases": r0["phases"]}
    if trace:
        out["records"] = records(cfg, wl, r0, chips)
        out["trace"] = dict(r0.get("trace") or {})
        traces = [r["trace"] for r in ranks if r.get("trace")]
        if traces:  # the device's busy and traced seconds, averaged over the cards
            for key in ("busy_s", "window_s"):
                out["trace"][key] = sum(t[key] for t in traces) / len(traces)
    return out
