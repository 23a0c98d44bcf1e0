"""Serving cells: requests that arrive at a fixed rate, each a clip of
uint8 frames scored through the program's
``inference.Predictor.predict_video`` (K1, the eval forward in fixed
batches, the last one padded, the per-video mean), one after the other as
the one card serves them.

The workload's parameters: ``batch_size`` (the Predictor's); ``lengths``
(the clip lengths, each once in a cycle, in an order drawn from the seed for
every cycle); ``rate_per_s`` (one request arrives every 1 / rate seconds:
above what the card scores, the queue never empties and the window reads
the card's rate);
``pool_frames``, ``warmup_requests``, ``calibrate_frames``,
``trace_requests``, ``check_requests`` and the ``limits``.

A run:

1. set-up: the weights made on the card from the seed, their BatchNorm
   statistics measured by the float32 reference on seeded frames (as a
   served model's are; the reference's seconds are left out of
   ``setup_s``), the Predictor built from them; a pool of ``pool_frames``
   seeded frames on the host; ``warmup_requests`` requests;
2. the window: requests one after the other, each once it has arrived,
   until ``--seconds`` have passed and the cycle is whole, each clip
   starting at a seeded frame of the pool; a request that arrives while the
   card serves another waits. Every seed gets the same lengths and the same
   arrivals;
3. with ``--trace 1``: ``trace_requests`` more at the same rate under the
   profiler;
4. the Predictor freed, the reference scores ``check_requests`` finished
   requests drawn from the seed, and the widest gap of a score
   (``score_gap``) is compared with the workload's limit.
"""

from __future__ import annotations

import gc
import itertools
import sys
import time

import numpy as np
import torch

from perfbench import harness, roofline, weights
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.reference.numerics import Numerics
from perfbench.trace import SPAN_PREFIX, profile_window


def served_weights(cfg: dict, wl: dict, seed: int, dev) -> dict:
    sd = weights.make_state_dict(cfg, seed, dev)
    return weights.calibrate(cfg, sd, seed, dev, cfg["data"]["input_size"],
                             wl["calibrate_frames"])


def frame_pool(cfg: dict, wl: dict, seed: int, dev) -> np.ndarray:
    size = cfg["data"]["input_size"]
    return weights.frames(wl["pool_frames"], size, weights.generator(seed, dev, "frames"),
                          dev).cpu().numpy()


def schedule(wl: dict, seed: int, stream: str = "clips"):
    """Endless (length, first frame) of the requests: each cycle every length
    once, in a seeded order."""
    rng = np.random.default_rng(weights.sub_seed(seed, stream))
    lengths = list(wl["lengths"])
    while True:
        for i in rng.permutation(len(lengths)):
            n = lengths[i]
            yield n, int(rng.integers(0, wl["pool_frames"] - n + 1))


def arrivals(wl: dict, count: int) -> list:
    """Seconds from the start at which each of ``count`` requests arrives,
    one every 1 / ``rate_per_s``."""
    return [i / wl["rate_per_s"] for i in range(count)]


def build_program(cfg: dict, wl: dict, sd: dict, dev):
    from unidefense_torch.inference import Predictor

    data = cfg["data"]
    dtype = torch.bfloat16 if cfg["config"].get("precision") == "bf16" else torch.float32
    model_cfg = {k: v for k, v in cfg["model"].items() if k != "name"}
    return Predictor(cfg["model"]["name"], model_cfg, state_dict=sd,
                     input_size=data["input_size"], batch_size=wl["batch_size"], dtype=dtype,
                     mean=tuple(data["mean"]), std=tuple(data["std"]), device=dev, v4_widths=())


def serve(pred, frames: np.ndarray, requests: list, offsets: list = None,
          seconds: float = None, cycle: int = 1) -> tuple:
    """(done, seconds): the (length, first frame) ``requests``, each served
    once it has arrived, ``offsets`` seconds after the start (back to back
    without them), all of them or until ``seconds`` have passed and a whole
    number of ``cycle`` requests is done; each done as (length, first frame,
    score, latency from its arrival, service seconds), and the seconds from
    the start to the last one's end."""
    done = []
    t0 = time.perf_counter()
    for i, (n, at) in enumerate(requests):
        due = t0 + offsets[i] if offsets is not None else time.perf_counter()
        while (left := due - time.perf_counter()) > 0:
            time.sleep(left)
        with torch.profiler.record_function(SPAN_PREFIX + "stage"):
            clip = frames[at:at + n]
        with torch.profiler.record_function(SPAN_PREFIX + "predict_video"):
            t = time.perf_counter()
            score = pred.predict_video(clip)
            end = time.perf_counter()
        done.append((n, at, score, end - due, end - t))
        if seconds is not None and end - t0 >= seconds and len(done) % cycle == 0:
            break
    return done, time.perf_counter() - t0


def sample(done: list, wl: dict, seed: int) -> list:
    """``check_requests`` finished requests drawn from the seed, the longest
    clip among them."""
    rng = np.random.default_rng(weights.sub_seed(seed, "check sample"))
    take = min(wl["check_requests"], len(done))
    longest = max(range(len(done)), key=lambda i: done[i][0])
    rest = [i for i in range(len(done)) if i != longest]
    picked = [longest] + [rest[i] for i in rng.choice(len(rest), take - 1, replace=False)]
    return [done[i] for i in sorted(picked)]


def reference_scores(cfg: dict, sd: dict, frames: np.ndarray, requests: list, dev,
                     nx: Numerics) -> tuple:
    """(scores, spread): the reference's video score of each (length, first
    frame, ...) request, the mean P(real) of its frames, float32 unless
    ``nx`` says; and the root mean square of P(real) − 1/2 over all those
    frames, the scale a score's gap is read against."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = ref_model.build(cfg["model"], nx, sd, dev)
        scores, squares, count = [], 0.0, 0
        for n, at, *_ in requests:
            clip = torch.from_numpy(np.ascontiguousarray(frames[at:at + n])).to(dev)
            p = ref_train.frame_scores(model, clip).double()
            scores.append(float(p.mean()))
            squares += float((p - 0.5).pow(2).sum())
            count += n
        return scores, (squares / count) ** 0.5
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def score_gaps(got: list, ref: tuple) -> list:
    """Each request's gap of its video score from the reference's, over the
    spread of the reference's frame probabilities about 1/2."""
    scores, spread = ref
    return [abs(a - b) / spread for a, b in zip(got, scores)]


def score_gap(got: list, ref: tuple) -> float:
    """The widest request's gap (``score_gaps``): every answer is judged."""
    return max(score_gaps(got, ref))


def end_to_end(done: list, secs: float) -> dict:
    """Frames asked for (padding not counted) in every request of the window
    over its seconds."""
    return {"serve_frames_per_s": sum(r[0] for r in done) / secs}


def quarter_services(done: list) -> list:
    """For each quarter of the window's requests, the median, 95th
    percentile and largest of their service times, in ms: where the window's
    time went."""
    out = []
    for i in range(4):
        part = done[i * len(done) // 4:(i + 1) * len(done) // 4] or done
        svc = sorted(r[4] * 1e3 for r in part)
        out.append(f"{svc[len(svc) // 2]:.1f}/{harness.p95(svc):.1f}/{svc[-1]:.1f}")
    return out


def records(cfg: dict, wl: dict, done: list, secs: float, trace: dict) -> dict:
    work = roofline.model_work(cfg["model"], 1, cfg["data"]["input_size"])
    k2, _ = roofline.sfconv_bounds(work["sfconvs"], wl["batch_size"], train=False)
    return {"kind": "serve", "chips": 1, "trace": trace,
            "window": {"requests": len(done), "frames": sum(r[0] for r in done),
                       "service_s": sum(r[4] for r in done), "seconds": secs},
            "flops_per_unit": work["flops"], "peak_flops": harness.PEAK_BF16_FLOPS,
            "k2_bound_ms_per_unit": k2}


def run(cell: str, wl: dict, cfg: dict, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> dict:
    if wl["chips"] != 1:
        raise NotImplementedError("serving cells run on one card")
    phases = harness.Phases(t_start)
    if dev.type == "cuda":
        torch.cuda.init()
    phases.mark("start, imports and the CUDA context")
    sd = weights.make_state_dict(cfg, seed, dev)
    phases.mark("weights")
    sd = weights.calibrate(cfg, sd, seed, dev, cfg["data"]["input_size"],
                           wl["calibrate_frames"])
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    phases.mark("the weights' statistics by the reference (not in setup_s)")
    reference_s = phases.parts[-1][1]
    pred = build_program(cfg, wl, sd, dev)
    phases.mark("Predictor built")
    frames = frame_pool(cfg, wl, seed, dev)
    phases.mark("frames")
    warm = list(itertools.islice(schedule(wl, seed, "warm-up"), wl["warmup_requests"]))
    serve(pred, frames, warm[:1])
    phases.mark("request 1 (kernels built or loaded, first plans)")
    serve(pred, frames, warm[1:])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    phases.mark("warm-up requests")
    setup_s = time.time() - t_start - reference_s
    cycle = len(wl["lengths"])
    count = (int(seconds * wl["rate_per_s"]) // cycle + 1) * cycle
    requests = schedule(wl, seed)
    done, secs = serve(pred, frames, list(itertools.islice(requests, count)),
                       arrivals(wl, count), seconds, cycle)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e = {**end_to_end(done, secs), "setup_s": setup_s}
    phases.mark("window")
    print("service by quarter of the window (p50/p95/max ms): " + "; ".join(
        quarter_services(done)), file=sys.stderr)
    traced = {}
    if trace and dev.type == "cuda":
        more = list(itertools.islice(requests, wl["trace_requests"]))
        offsets = arrivals(wl, len(more))

        def traced_requests():
            served, _ = serve(pred, frames, more, offsets)
            return sum(-(-n // wl["batch_size"]) for n, *_ in served)

        traced = profile_window(traced_requests, dev)
    del pred
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checked = sample(done, wl, seed)
    ref = reference_scores(cfg, sd, frames, checked, dev, Numerics())
    phases.mark("trace and the reference")
    out = {"e2e": e2e, "attempted": len(done), "failed": 0,
           "numbers": {"score_gap": score_gap([r[2] for r in checked], ref)}, "peak": peak,
           "phases": phases.parts}
    if trace:
        out["records"] = records(cfg, wl, done, secs, traced)
        out["trace"] = traced
    return out
