"""A cell's program timed three ways in one process, on the chip: untraced,
under the full trace the benchmark's ``--trace 1`` runs take
(``trace.profile_window``) and in the light window (``spans.light_window``);
the benchmark's own runs do not run this.

    python3 perfbench/light.py --workload <cell> --seed <n> --seconds <s> [--repeats 2]

One card. After the cell's set-up (its driver's: weights, the program, the
first steps or requests), it runs the untraced window for ``--seconds``,
then ``--repeats`` times the full trace and the light window, each over the
workload's ``trace_steps`` steps or ``trace_requests`` requests, and
prints one JSON line: the ms per step or batch of each, the device's idle
share of each, the readings of ``METRICS`` and the blocking calls by span
from each light window (read by ``perfbench/metrics/<name>.py`` from the
light window and, in serving, the ``Predictor.counts`` of the untraced
window), the last light window's spans, the full trace's device
operations, in serving each traced request's service ms (both traces'),
and what a span costs the host off and on.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

METRICS = ("step_idle_pct.train", "fwd_host_ms_per_step.train", "bwd_host_ms_per_step.train",
           "perturb_host_ms_per_step.train", "host_syncs_per_step.train",
           "request_idle_pct.serve", "stage_host_ms_per_batch.serve",
           "launch_host_ms_per_batch.serve", "serve_pad_pct")


def span_cost_us(n: int = 100_000) -> dict:
    """Host µs of one ``with span(...)`` with nothing recording, and with a
    recorder open."""
    from unidefense_torch.utils.tracing import recording, span

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with span("ud.cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    off = loop()
    with recording():
        on = loop()
    return {"off": off, "on": on}


def _train(wl, cfg, seed, seconds, dev):
    from perfbench import train_cell, weights

    sd = weights.make_state_dict(cfg, seed, dev)
    state, step = train_cell.build_program(cfg, wl, sd, dev)
    del sd
    feed = train_cell.Feed(step, state, train_cell.pool(seed, 0, wl, cfg, dev), wl, seed, 0, dev)
    train_cell.first_steps(feed, wl["check_steps"] + wl["warmup_steps"], keep=False)
    steps, secs = train_cell.window(feed, seconds)

    def traced():
        for _ in range(wl["trace_steps"]):
            feed()
        return wl["trace_steps"]

    return {"units": steps, "seconds": secs}, traced, {"kind": "train"}


def _serve(wl, cfg, seed, seconds, dev):
    import itertools

    from perfbench import serve_cell

    sd = serve_cell.served_weights(cfg, wl, seed, dev)
    pred = serve_cell.build_program(cfg, wl, sd, dev)
    del sd
    frames = serve_cell.frame_pool(cfg, wl, seed, dev)
    serve_cell.serve(pred, frames, list(itertools.islice(serve_cell.schedule(wl, seed, "warm-up"),
                                                         wl["warmup_requests"])))
    cycle = len(wl["lengths"])
    count = (int(seconds * wl["rate_per_s"]) // cycle + 1) * cycle
    requests = serve_cell.schedule(wl, seed)
    before = dict(pred.counts)
    done, secs = serve_cell.serve(pred, frames, list(itertools.islice(requests, count)),
                                  serve_cell.arrivals(wl, count), seconds, cycle)
    counts = {k: v - before[k] for k, v in pred.counts.items()}

    def traced():
        more = list(itertools.islice(requests, wl["trace_requests"]))
        served, _ = serve_cell.serve(pred, frames, more, serve_cell.arrivals(wl, len(more)))
        window.setdefault("traced_service_ms", []).append([1e3 * r[4] for r in served])
        return sum(-(-n // wl["batch_size"]) for n, *_ in served)

    window = {"units": counts["batches"], "seconds": secs, "requests": len(done),
              "service_ms_max": 1e3 * max(r[4] for r in done)}
    return window, traced, {"kind": "serve", "counts": counts}


def measure(cell: str, seed: int, seconds: float, repeats: int, device: str = "cuda",
            wl: dict = None, cfg: dict = None) -> dict:
    """The line ``main`` prints; ``wl`` and ``cfg`` default to the cell's
    files (the tests pass their own, and ``device="cpu"``, where the full
    trace is left out)."""
    import torch

    from perfbench.spans import light_window
    from perfbench.trace import profile_window

    wl = wl or harness.workload(cell)
    cfg = cfg or harness.config(wl["config"])
    dev = torch.device(device)
    setup = {"train": _train, "serve": _serve}[wl["kind"]]
    window, traced, rec = setup(wl, cfg, seed, seconds, dev)
    out = {"workload": cell, "seed": seed, "device": harness.device_info(1, 0)["kind"],
           "ms_per_unit": {"untraced": 1e3 * window["seconds"] / window["units"],
                           "full": [], "light": []},
           "idle_pct": {"full": [], "light": []}, "window": window}
    for _ in range(repeats):
        if dev.type == "cuda":
            full = profile_window(traced, dev)
            out["ms_per_unit"]["full"].append(1e3 * full["window_s"] / full["units"])
            out["idle_pct"]["full"].append(100 * (1 - full["busy_s"] / full["window_s"]))
            out["full_device_ops"] = full["device_ops"]
        light = light_window(traced, dev)
        out["ms_per_unit"]["light"].append(1e3 * light["window_s"] / light["units"])
        out["idle_pct"]["light"].append(100 * (1 - light["busy_s"] / light["window_s"]))
        readings = {name: harness.reader(name)(dict(rec, spans=light)) for name in METRICS}
        out.setdefault("metrics", []).append(
            {name: v for name, v in readings.items() if v is not None})
        out.setdefault("sync_calls", []).append(light["sync_calls"])
    out["spans"], out["outside"] = light["spans"], light["outside"]
    out["span_cost_us"] = span_cost_us()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--repeats", type=int, default=2)
    args = p.parse_args()
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or harness.workload(args.workload)["chips"] != 1:
        print("light.py runs a one-card cell on a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(measure(args.workload, args.seed, args.seconds, args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
