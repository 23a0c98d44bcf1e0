"""BENCHMARK.json against the rules a benchmark file keeps, the files the
harness finds by name, and the imports of every module under perfbench/."""

import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PERFBENCH = Path(harness.BENCH_DIR)


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_every_name_uses_the_allowed_characters(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_unit_a_direction_and_a_source(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = ("host_clock", "device_trace") if "bound" in metric else (
        "device_trace", "program_span", "program_counter", "host_clock")
    assert metric["source"] in allowed


def test_file_shape_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(cells) == len(set(cells))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] \
            + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_each_cell_reports_what_its_metrics_need():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = w["name"]
        mine = [m["name"] for m in harness.metrics_of(BENCH, cell, "end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2
        assert harness.metrics_of(BENCH, cell, "per_layer")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reported = [x["name"] for x in harness.metrics_of(BENCH, cell, "end_to_end")]
            assert m["moves"] in reported, (m["name"], cell)


def test_the_harness_finds_every_file_by_name():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert harness.config(c["name"])["source"] == c["source"]
    for w in BENCH["workloads"]:
        wl = harness.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PERFBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "unidefense_torch" not in set(_imports(path))
    assert set(_imports(path)) <= {"__future__", "math", "dataclasses", "typing", "functools",
                                   "importlib",
                                   "numpy", "torch", "perfbench"}


def test_top_level_names_are_compared_whole():
    import sys

    # the port's name begins with the JAX package's: neither it nor a longer
    # name that begins with "jax" counts, the JAX package itself does
    probes = ("unidefense_torch_probe", "unidefense_tpu", "jaxtyping_probe")
    for name in probes:
        sys.modules[name] = object()
    try:
        found = harness.forbidden_modules()
        assert "unidefense_tpu" in found
        assert "unidefense_torch_probe" not in found and "jaxtyping_probe" not in found
    finally:
        for name in probes:
            del sys.modules[name]
