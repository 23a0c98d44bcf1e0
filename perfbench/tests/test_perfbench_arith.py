"""The benchmark's arithmetic on synthetic records and hand figures."""

import time

import pytest
import torch

from perfbench import harness, roofline, serve_cell, train_cell, trace
from perfbench.reference import model as ref_model
from perfbench.reference.numerics import Numerics


def test_union_counts_overlapping_kernels_once():
    # two streams: [0, 10) and [5, 12) overlap; [20, 25) stands alone
    assert trace.union_length([(0, 10), (5, 12), (20, 25)]) == 17
    assert trace.gaps([(0, 10), (5, 12), (20, 25)], -3, 30) == [(-3, 0), (12, 20), (25, 30)]


def test_reduce_events_idle_share_groups_and_labels():
    dev = [("sfconv_mix_wgmma_kernel", 0.0, 40.0), ("elementwise_kernel", 30.0, 60.0),
           ("Memcpy HtoD (Pageable -> Device)", 70.0, 80.0), ("ncclKernel_AllReduce", 90.0, 95.0)]
    host = [("perfbench.step", -5.0, 100.0), ("aten::item", 60.0, 69.0),
            ("aten::copy_", 80.0, 89.0)]
    rec = trace.reduce_events(dev, host, (0.0, 100.0), units=2)
    assert rec["window_s"] == pytest.approx(100e-6)
    assert rec["busy_s"] == pytest.approx(75e-6)  # [0, 60) + [70, 80) + [90, 95)
    assert rec["groups_ms"]["K2 channel mix"] == pytest.approx(0.04)
    assert rec["groups_ms"][trace.GLUE] == pytest.approx(0.03 + 0.005)  # the NCCL kernel too
    assert rec["h2d_ms"] == pytest.approx(0.01)
    assert rec["nccl_ms"] == pytest.approx(0.005)
    idle = dict(rec["idle_gaps"])
    assert idle["step / aten::item"] == pytest.approx(10e-6)
    assert idle["step / aten::copy_"] == pytest.approx(10e-6)
    assert idle["step"] == pytest.approx(5e-6)  # [95, 100): no host op open


def test_p95_over_every_request():
    values = [float(i) for i in range(1, 101)]
    assert harness.p95(values) == pytest.approx(95.05)
    done = [(8, 0, 0.5, 0.1, 0.1)] * 19 + [(64, 0, 0.5, 0.3, 0.3)]
    e2e = serve_cell.end_to_end(done, secs=2.0)
    assert e2e["serve_frames_per_s"] == pytest.approx((19 * 8 + 64) / 2.0)
    # 18.05 of 19 sorted places: 100 ms + 0.05 of the step to 300 ms
    assert harness.p95([r[3] for r in done]) * 1e3 == pytest.approx(110.0)


class _Feed:
    dev = torch.device("cpu")

    def __init__(self, step_s):
        self.step_s, self.calls = step_s, 0

    def __call__(self):
        time.sleep(self.step_s)
        self.calls += 1


def test_training_window_counts_every_step_and_all_its_time():
    feed = _Feed(0.02)
    steps, secs = train_cell.window(feed, 0.1)
    assert steps == feed.calls
    assert secs >= 0.1 and steps == pytest.approx(secs / 0.02, abs=1.5)


def test_serving_window_ends_on_whole_cycles():
    class Pred:
        def predict_video(self, clip):
            time.sleep(0.03)
            return 0.5

    import numpy as np
    wl = {"lengths": [8, 16, 24], "pool_frames": 64, "rate_per_s": 20.0}
    requests = [r for _, r in zip(range(3), serve_cell.schedule(wl, 5))]
    assert sorted(n for n, _ in requests) == [8, 16, 24]
    # one every 50 ms; the second arrives while the first is served at 0 to 30 ms
    offsets = [0.0, 0.01, 0.1]
    done, secs = serve_cell.serve(Pred(), np.zeros((64, 2, 2, 3), np.uint8), requests,
                                  offsets)
    latency, service = [r[3] for r in done], [r[4] for r in done]
    assert all(s >= 0.03 for s in service)
    assert latency[1] >= 0.05 and latency[1] == pytest.approx(latency[0] + service[1] - 0.01,
                                                              abs=0.005)
    assert latency[2] == pytest.approx(service[2], abs=0.005)
    assert secs >= 0.13
    assert serve_cell.arrivals(wl, 4) == pytest.approx([0.0, 0.05, 0.1, 0.15])
    # a backlog: the window stops on time, after a whole cycle
    many = [r for _, r in zip(range(30), serve_cell.schedule(wl, 5))]
    backlog = serve_cell.arrivals(dict(wl, rate_per_s=100.0), 30)
    done, secs = serve_cell.serve(Pred(), np.zeros((64, 2, 2, 3), np.uint8), many, backlog,
                                  seconds=0.1, cycle=3)
    assert len(done) == 6 and secs >= 0.1
    assert sorted(r[0] for r in done[3:]) == [8, 16, 24]


def test_sfconv_bound_against_hand_figures():
    # K2 at (12^2, C 1632), b64: FLOPs 64*12*(8*12*1632^2 + 2*12*12*1632);
    # bytes 2*64*12*12*1632*2 + 4*1632^2*2 -> bound by FLOPs
    flops = 64 * 12 * (8 * 12 * 1632 ** 2 + 2 * 12 * 12 * 1632)
    assert roofline.k2_bound_ms(64, 12, 1632) == pytest.approx(flops / 989e12 * 1e3)
    # at (95^2, C 192) the bytes bound it
    nbytes = 2 * 64 * 95 * 95 * 192 * 2 + 4 * 192 * 192 * 4
    assert roofline.k2bwd_bound_ms(64, 95, 192) == pytest.approx(
        max(64 * 95 * (8 * 95 * 192 ** 2 + 2 * 95 * 95 * 192) / 989e12, nbytes / 3.35e12) * 1e3)


def test_flop_count_of_an_sfconv_against_a_hand_figure():
    from torch.utils.flop_counter import FlopCounterMode

    c, hw, k = 16, 12, 3
    conv = ref_model.SFConv(Numerics(), c, k, 1, "SAME", groups=c)
    x = torch.zeros(2, c, hw, hw, device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        conv(x)
    depthwise = 2 * 2 * hw * hw * c * k * k
    mix = 2 * 2 * hw * (hw // 2 + 1) * (2 * c) ** 2  # the packed spectrum through (2C, 2C)
    assert counter.get_total_flops() == depthwise + mix


def test_udr50_sfconv_shapes_and_step_flops():
    work = roofline.model_work({"name": "UDR50"}, 1, 380)
    # chip_smoke.SFCONV_SHAPES["UDR50", 380], expanded
    want = [(95, 128)] + [(48, 128)] * 3 + [(48, 256)] + [(24, 256)] * 5 + [(24, 512), (12, 512)]
    assert work["sfconvs"] == want
    k2, k2bwd = roofline.sfconv_bounds(want, 64, train=True)
    assert k2 == pytest.approx(4 * sum(roofline.k2_bound_ms(64, h, c) for h, c in want))
    assert k2bwd == pytest.approx(2 * sum(roofline.k2bwd_bound_ms(64, h, c) for h, c in want))


def test_readers_return_nothing_without_their_records():
    rec = {"kind": "serve", "chips": 1, "trace": {}, "window": {"frames": 0, "service_s": 0.0,
                                                              "seconds": 0.0}}
    bench = harness.benchmark()
    for m in bench["per_layer"]:
        assert harness.reader(m["name"])(rec) is None, m["name"]
