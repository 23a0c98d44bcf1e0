"""The readings that a cell's limits are set from, on the chip at the cell's
own sizes; the benchmark's own runs do not run this.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --program --control

For every seed it prints one JSON line with the compared numbers of:

- ``control`` (with ``--control``): the reference put in the program's
  place, rounded to float8 where the program holds bfloat16, the precision
  the configuration states: its gaps from the float32 reference are the
  upper readings;
- ``half`` (training, with ``--control``): the reference with every loss
  taken over half of each rank's reals and fakes (half of the batch left
  out, the mean taken over the rest), a fault that a limit has to catch;
- ``unchanged`` (training, with ``--control``): the reference whose updates
  change nothing (a step that returns its state unchanged), another such
  fault;
- ``program`` (with ``--program``, one-card cells): the program's own gaps,
  a lower reading, from the same set-up and the first steps (training) or
  ``check_requests`` requests (serving) that a run makes;
- ``program_fp32`` (``--witness``, training): the program run in float32
  with TF32 off, a second witness that sides with the reference or not.

Each reading is judged as a run judges its numbers (``harness.judge``,
with the workload's own ``limits``): ``correct`` and the numbers ``over``
their limits stand beside it. The control and every fault have to come out
not correct, the program correct.

``--look N`` adds a look at what the numbers read: each step's loss gap and
the N worst leaves (training), every request's gap (serving).
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


def train_readings(wl: dict, cfg: dict, seed: int, dev, program: bool, control: bool,
                   look: int = 0, witness: bool = False) -> dict:
    import copy

    import torch

    from perfbench import train_cell, weights
    from perfbench.reference.numerics import Numerics

    out = {}
    if program:
        sd = weights.make_state_dict(cfg, seed, dev)
        prog_cfg = copy.deepcopy(cfg)
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        if witness:  # the program in float32, TF32 off: a second witness
            prog_cfg["config"]["precision"] = "fp32"
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        state, step = train_cell.build_program(prog_cfg, wl, sd, dev)
        del sd
        feed = train_cell.Feed(step, state, train_cell.pool(seed, 0, wl, cfg, dev), wl, seed, 0,
                               dev)
        got = train_cell.first_steps(feed, wl["check_steps"], keep=True)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        del feed, state, step
        torch.cuda.empty_cache()
    ref = train_cell.reference_steps(cfg, wl, seed, dev, Numerics())
    if program:
        out["program_fp32" if witness else "program"] = train_cell.gaps(got, ref, look)
    for name, nx, fault in (("control", Numerics(fp8=True), None),
                            ("half", Numerics(), "half"), ("unchanged", Numerics(), "unchanged")):
        if not control:
            break
        other = train_cell.reference_steps(cfg, wl, seed, dev, nx, fault)
        out[name] = train_cell.gaps(other, ref, look)
        del other
        torch.cuda.empty_cache()
    return out


def serve_readings(wl: dict, cfg: dict, seed: int, dev, program: bool, control: bool,
                   look: int = 0, witness: bool = False) -> dict:
    import itertools

    from perfbench import serve_cell
    from perfbench.reference.numerics import Numerics

    sd = serve_cell.served_weights(cfg, wl, seed, dev)
    frames = serve_cell.frame_pool(cfg, wl, seed, dev)
    requests = list(itertools.islice(serve_cell.schedule(wl, seed), wl["check_requests"]))
    ref = serve_cell.reference_scores(cfg, sd, frames, requests, dev, Numerics())
    out = {}
    if program:
        pred = serve_cell.build_program(cfg, wl, sd, dev)
        got = [r[2] for r in serve_cell.serve(pred, frames, requests)[0]]
        del pred
        out["program"] = {"score_gap": serve_cell.score_gap(got, ref)}
        if look:
            out["program"]["gaps"] = serve_cell.score_gaps(got, ref)
    if control:
        ctl = serve_cell.reference_scores(cfg, sd, frames, requests, dev, Numerics(fp8=True))
        out["control"] = {"score_gap": serve_cell.score_gap(ctl[0], ref)}
        if look:
            out["control"]["gaps"] = serve_cell.score_gaps(ctl[0], ref)
    return out


def judged(readings: dict, limits: dict) -> dict:
    """Each reading with ``correct`` and the names ``over`` their limits, as
    a run of the cell would judge them."""
    out = {}
    for name, numbers in readings.items():
        correct, checks = harness.judge(numbers, limits)
        over = [k for k, c in checks.items() if c["value"] is None or c["value"] > c["limit"]]
        out[name] = {**numbers, "correct": correct, "over": over}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--look", type=int, default=0,
                   help="also print the N worst leaves of each training number")
    p.add_argument("--witness", action="store_true",
                   help="the program in float32 with TF32 off (training)")
    args = p.parse_args()
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the chip", file=sys.stderr)
        return 2
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    dev = torch.device("cuda")
    readings = {"train": train_readings, "serve": serve_readings}[wl["kind"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(wl, cfg, seed, dev, args.program and wl["chips"] == 1, args.control,
                       args.look, args.witness)
        got = judged(got, wl["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
