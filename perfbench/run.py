"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's workload file
(``perfbench/workloads/<cell>.json``) names its configuration
(``perfbench/configs/<config>.json``) and its kind, ``train`` or ``serve``.
The workload's ``kind`` names its driver, ``perfbench/<kind>_cell.py``.
The run sets up, measures for ``--seconds``, checks what the timed path
produced against the reference, and prints one JSON line last: the cell's
end-to-end metrics of ``BENCHMARK.json``, or with ``--trace 1`` its
per-layer metrics, each read by ``perfbench/metrics/<metric>.py``. It exits
with another code than 0 and prints no result without the cards the cell
asks for, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: dict = None, wl: dict = None, cfg: dict = None) -> dict:
    """The result of one run; ``bench``, ``wl`` and ``cfg`` default to the
    files of ``cell`` (the tests pass their own, and ``device="cpu"``)."""
    import importlib

    import torch

    bench = bench or harness.benchmark()
    wl = wl or harness.workload(cell)
    cfg = cfg or harness.config(wl["config"])
    dev = torch.device(device)
    driver = importlib.import_module(f"perfbench.{wl['kind']}_cell")
    got = driver.run(cell, wl, cfg, seed, seconds, trace, dev, T_START)
    print("phases: " + ", ".join(f"{n} {s:.3f} s" for n, s in got["phases"]), file=sys.stderr)
    correct, checks = harness.judge(got["numbers"], wl["limits"])
    if trace:
        metrics = harness.per_layer_values(bench, cell, got["records"])
    else:
        metrics = harness.end_to_end_values(bench, cell, got["e2e"])
    result = {"correct": correct, "attempted": got["attempted"], "failed": got["failed"],
              "metrics": metrics,
              "device": harness.device_info(wl["chips"], got["peak"], got.get("trace"))}
    tr = got.get("trace")
    if trace and tr:
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    chips = harness.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
