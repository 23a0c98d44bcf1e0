"""What every cell shares: finding its files by name, the caches' fixed
directories, the device's description, the per-layer readers, the check
that nothing of JAX was loaded, and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout
BENCH_DIR = ROOT / "perfbench"
CACHE_DIR = BENCH_DIR / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "unidefense_tpu")
PEAK_BF16_FLOPS = 989e12  # one NVIDIA H100 SXM, dense bf16 (data sheet)
PEAK_HBM_BYTES = 3.35e12


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's nvcc libraries stay in ``unidefense_torch/build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("UD_SFCONV_V4", None)  # the default route: K2 everywhere


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    each compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """``read(records) -> float | None`` of ``perfbench/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_values(bench: dict, cell: str, records: dict) -> dict:
    out = {}
    for m in metrics_of(bench, cell, "per_layer"):
        value = reader(m["name"])(records)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end_values(bench: dict, cell: str, values: dict) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in metrics_of(bench, cell, "end_to_end") if m["name"] in values}


def p95(values: list) -> float:
    """95th percentile of every value (Python's inclusive quantiles)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def device_info(count: int, peak_bytes: int, trace: dict = None) -> dict:
    import torch

    info = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
            "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
            "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


class Phases:
    """Seconds of each part of a run since the part before, from the
    process's start: the parts of ``setup_s``, which a run prints to
    standard error."""

    def __init__(self, t_start: float):
        import time

        self.clock, self.last, self.parts = time.time, t_start, []

    def mark(self, name: str) -> None:
        now = self.clock()
        self.parts.append((name, now - self.last))
        self.last = now


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number that has a limit (the workload's
    ``limits``) finite and at most it; a limit whose number is missing
    fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        finite = value is not None and math.isfinite(value)
        checks[name] = {"value": value if finite else None, "limit": limit}
    return ok and bool(limits), checks


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
