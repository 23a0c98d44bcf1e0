"""The light window's arithmetic (``perfbench/spans.py``) on synthetic events,
its readers, the full trace's records beside the program's spans, and
``perfbench/light.py`` end to end on the CPU at a tiny size."""

import pytest

from perfbench import harness, light, spans, trace
from perfbench.tests.test_perfbench_reference import tiny_config, tiny_serve, tiny_train

MS = 1_000_000  # ns


def _ms(*times):
    return [t * MS for t in times]


def _light():
    """A step 0-100 ms holding two forwards and the perturbation, in a
    window to 110 ms; the card busy at 0-20, 30-45 and 60-65."""
    recorded = [("ud.train.step", *_ms(0, 100), -1, 1), ("ud.train.forward", *_ms(10, 40), 0, 1),
                ("ud.train.perturb", *_ms(50, 70), 0, 1), ("ud.train.forward", *_ms(75, 85), 0, 1)]
    device = [("k1", *_ms(0, 20)), ("k2", *_ms(30, 45)), ("Memcpy HtoD", *_ms(60, 65))]
    runtime = [("cudaLaunchKernel", *_ms(12, 13)), ("cudaMemcpyAsync", *_ms(15, 16)),
               ("cudaStreamSynchronize", *_ms(55, 58)), ("cudaMemcpy", *_ms(80, 81)),
               ("cudaDeviceSynchronize", *_ms(105, 106))]
    return spans.reduce_spans(recorded, device, runtime, tuple(_ms(0, 110)), units=1)


def test_idle_gaps_are_cut_at_span_edges_and_go_to_the_innermost_span():
    rec = _light()
    s = rec["spans"]
    assert rec["window_s"] == pytest.approx(0.11) and rec["busy_s"] == pytest.approx(0.04)
    # gaps 20-30 (forward), 45-50 (step), 50-60 and 65-70 (perturb), 70-75 (step),
    # 75-85 (forward), 85-100 (step), 100-110 (outside)
    assert s["ud.train.forward"]["self_idle_ms"] == pytest.approx(20)
    assert s["ud.train.perturb"]["self_idle_ms"] == pytest.approx(15)
    assert s["ud.train.step"]["self_idle_ms"] == pytest.approx(25)
    assert rec["outside"]["idle_ms"] == pytest.approx(10)
    assert s["ud.train.step"]["idle_ms"] == pytest.approx(60)
    assert s["ud.train.forward"]["idle_ms"] == pytest.approx(20)
    total = sum(v["self_idle_ms"] for v in s.values()) + rec["outside"]["idle_ms"]
    assert total == pytest.approx(1e3 * (rec["window_s"] - rec["busy_s"]))


def test_self_time_is_wall_less_the_children():
    s = _light()["spans"]
    assert s["ud.train.forward"]["count"] == 2
    assert s["ud.train.forward"]["wall_ms"] == pytest.approx(40)
    assert s["ud.train.step"]["wall_ms"] == pytest.approx(100)
    assert s["ud.train.step"]["self_ms"] == pytest.approx(100 - 30 - 20 - 10)
    assert s["ud.train.perturb"]["self_ms"] == pytest.approx(20)


def test_syncs_count_blocking_calls_in_the_innermost_span():
    rec = _light()
    s = rec["spans"]
    assert spans.is_sync("cudaStreamSynchronize") and spans.is_sync("cudaMemcpy")
    assert not spans.is_sync("cudaLaunchKernel") and not spans.is_sync("cudaMemcpyAsync")
    assert s["ud.train.perturb"]["self_syncs"] == 1
    assert s["ud.train.forward"]["self_syncs"] == 1  # the cudaMemcpy at 80 ms
    assert s["ud.train.step"]["self_syncs"] == 0 and s["ud.train.step"]["syncs"] == 2
    assert rec["outside"]["syncs"] == 1
    assert rec["sync_calls"] == {"ud.train.perturb / cudaStreamSynchronize": 1,
                                 "ud.train.forward / cudaMemcpy": 1,
                                 "outside / cudaDeviceSynchronize": 1}


def test_a_span_left_open_ends_with_the_window():
    rec = spans.reduce_spans([("ud.serve.request", *_ms(10), None, -1, 1)], [], [],
                             tuple(_ms(0, 30)), units=1)
    assert rec["spans"]["ud.serve.request"]["wall_ms"] == pytest.approx(20)
    assert rec["outside"]["idle_ms"] == pytest.approx(10)


def test_full_trace_records_stay_with_the_programs_spans_among_the_host_events():
    dev = [("sfconv_mix_wgmma_kernel", 0.0, 40.0), ("elementwise_kernel", 30.0, 60.0),
           ("Memcpy HtoD (Pageable -> Device)", 70.0, 80.0), ("ncclKernel_AllReduce", 90.0, 95.0)]
    host = [("perfbench.step", -5.0, 100.0), ("aten::item", 60.0, 69.0),
            ("aten::copy_", 80.0, 89.0)]
    ours = [("ud.train.step", -4.0, 99.5), ("ud.train.perturb", 59.0, 70.0)]
    before = trace.reduce_events(dev, host, (0.0, 100.0), units=2)
    after = trace.reduce_events(dev, host + ours, (0.0, 100.0), units=2)
    for key in set(before) - {"idle_gaps"}:
        assert after[key] == before[key], key
    # only a gap with no host operation open at its start now names the
    # program's span
    assert dict(after["idle_gaps"]) == {"step / aten::item": pytest.approx(10e-6),
                                        "step / aten::copy_": pytest.approx(10e-6),
                                        "step / ud.train.step": pytest.approx(5e-6)}
    assert dict(before["idle_gaps"])["step"] == pytest.approx(5e-6)


def test_new_readers_read_their_records_and_nothing_without_them():
    empty = [{"kind": kind, "chips": 1, "trace": {}, "window": {}} for kind in ("train", "serve")]
    for name in light.METRICS:
        for rec in empty:
            assert harness.reader(name)(rec) is None, name
    train = {"kind": "train", "spans": _light()}
    got = {name: harness.reader(name)(train) for name in light.METRICS}
    assert got["step_idle_pct.train"] == pytest.approx(60.0)
    assert got["fwd_host_ms_per_step.train"] == pytest.approx(40.0)
    assert got["perturb_host_ms_per_step.train"] == pytest.approx(20.0)
    assert got["host_syncs_per_step.train"] == 2
    assert got["bwd_host_ms_per_step.train"] is None  # no backward span
    served = spans.reduce_spans(
        [("ud.serve.request", *_ms(0, 70), -1, 1), ("ud.serve.stage", *_ms(0, 4), 0, 1),
         ("ud.serve.forward", *_ms(4, 50), 0, 1)],
        [("k", *_ms(5, 63))], [], tuple(_ms(0, 70)), units=1)
    serve = {"kind": "serve", "spans": served, "counts": {"frames": 5, "slots": 32, "batches": 1}}
    got = {name: harness.reader(name)(serve) for name in light.METRICS}
    assert got["request_idle_pct.serve"] == pytest.approx(100 * 12 / 70)
    assert got["stage_host_ms_per_batch.serve"] == pytest.approx(4.0)
    assert got["launch_host_ms_per_batch.serve"] == pytest.approx(46.0)
    assert got["serve_pad_pct"] == pytest.approx(84.375)
    assert got["step_idle_pct.train"] is None


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_light_tool_reads_the_programs_spans_on_the_cpu(kind):
    wl = tiny_train() if kind == "train" else tiny_serve()
    cell = "udeb4-train-b32" if kind == "train" else "udeb4-serve-clips"
    got = light.measure(cell, 2**31 + 5, 0.3, 1, device="cpu", wl=wl, cfg=tiny_config())
    assert got["ms_per_unit"]["untraced"] > 0 and len(got["ms_per_unit"]["light"]) == 1
    names = set(got["metrics"][0])
    if kind == "train":
        assert names == {m for m in light.METRICS if m.endswith(".train")}
        assert got["spans"]["ud.train.step"]["count"] == wl["trace_steps"]
    else:
        assert names == {m for m in light.METRICS if m.endswith(".serve")} | {"serve_pad_pct"}
        # clips of 2, 5 and 8 frames at batch 4: 15 frames in 5 batches a cycle
        assert wl["lengths"] == [2, 5, 8] and wl["batch_size"] == 4
        assert got["window"]["units"] % 5 == 0
        assert got["metrics"][0]["serve_pad_pct"] == pytest.approx(25.0)
        assert got["spans"]["ud.serve.request"]["count"] == wl["trace_requests"]
    assert got["span_cost_us"]["off"] < got["span_cost_us"]["on"]
