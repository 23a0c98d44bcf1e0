"""The port's spans and counters (unidefense_torch/utils/tracing.py, the
train steps' and ``Predictor``'s spans, ``Predictor.counts``) on the CPU:
UDR18 at 32², 2 real + 2 fake, fp32."""

import numpy as np
import pytest
import torch

from unidefense_torch.data.transforms import DevicePipeline
from unidefense_torch.inference import Predictor
from unidefense_torch.models.registry import build_model
from unidefense_torch.train import optim as toptim
from unidefense_torch.train.step import create_train_state, make_normal_train_step, make_train_step
from unidefense_torch.utils.tracing import recording, span

# config_template/forgery/model_udeb4.yml's config section
CFG = {"optimizer": {"name": "adamw", "lr": 1e-4, "betas": [0.9, 0.999], "weight_decay": 5e-6,
                     "amsgrad": True},
       "scheduler": {"name": "StepLR", "step_size": 22500, "gamma": 0.5},
       "lambda_triplet": 0.1, "lambda_recons": 0.1, "lambda_freq": 1.0, "lambda_mask": 0.1,
       "lambda_fac": 0.1}
SIZE, SUM_REAL, SUM_FAKE = 32, 2, 2
RATES = {"drop_rate": 0.2, "feat_drop_rate": 0.2}
PASS = ["ud.train.forward", "ud.train.backward", "ud.train.update"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # many small ops beside the other test workers (see test_torch_engine)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    return build_model("UDR18", RATES).state_dict()


def _run_step(weights, two_pass=True):
    """A fresh state from ``weights`` and one step on a seeded batch: (the
    step's results, the state)."""
    model = build_model("UDR18", RATES)
    model.load_state_dict(weights)
    tx = toptim.build_optimizer(CFG)[0]
    state = create_train_state(model, tx, device="cpu")
    pipe = DevicePipeline(hflip_p=0.5)
    step = (make_train_step(tx, CFG, 20, SUM_REAL, SUM_FAKE, preprocess=pipe) if two_pass
            else make_normal_train_step(tx, CFG, SUM_REAL, SUM_FAKE, preprocess=pipe))
    frames = np.random.default_rng(7).integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    batch = {"image": torch.from_numpy(frames), "label": torch.tensor([0, 0, 1, 1])}
    return step(state, batch, torch.Generator().manual_seed(11)), state


@pytest.fixture(scope="module")
def two_pass_runs(weights):
    """One two-pass step from ``weights`` with nothing recording and one
    under ``recording()``: (plain, recorded, the recorded spans)."""
    plain = _run_step(weights)
    with recording() as spans:
        traced = _run_step(weights)
    return plain, traced, spans


def _children(spans, parent):
    return [s for s in spans if s[3] == parent]


def test_span_is_one_shared_no_op_when_nothing_records():
    assert not torch.autograd._profiler_enabled()
    assert span("ud.a") is span("ud.b")
    with span("ud.a") as s:
        assert s is span("ud.c")
    with recording() as spans:
        assert span("ud.a") is not span("ud.a")
        with span("ud.a"):
            with span("ud.b"):
                pass
    assert [(n, p) for n, _, _, p, _ in spans] == [("ud.a", -1), ("ud.b", 0)]
    (_, s0, e0, _, _), (_, s1, e1, _, _) = spans
    assert s0 <= s1 <= e1 <= e0
    with span("ud.after"):  # the recorder is closed
        pass
    assert len(spans) == 2


@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "single_pass"])
def test_one_step_records_its_passes_in_order_inside_it(weights, two_pass_runs, two_pass):
    if two_pass:
        spans = two_pass_runs[2]
    else:
        with recording() as spans:
            _run_step(weights, two_pass)
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert [spans[i][0] for i in roots] == ["ud.train.step"]
    inside = _children(spans, roots[0])
    want = PASS + ["ud.train.perturb"] + PASS if two_pass else PASS
    assert [s[0] for s in inside] == want
    _, start, end, _, tid = spans[roots[0]]
    times = [start] + [t for s in inside for t in s[1:3]] + [end]
    assert times == sorted(times)
    assert {s[4] for s in spans} == {tid}
    assert len(spans) == 1 + len(want)


def test_recorded_spans_hold_the_profilers_events():
    """The recorder's clock is the profiler's: each recorded span holds the
    profiler's event of the same name, within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    def work():
        with span("ud.outer"):
            for _ in range(3):
                with span("ud.inner"):
                    torch.randn(64, 64) @ torch.randn(64, 64)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as spans:
            work()
    events = sorted((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("ud."))
    assert sorted(s[0] for s in spans) == [e[0] for e in events]
    for (name, start, end, _, _), (ename, estart, eend) in zip(sorted(spans), events):
        assert name == ename
        assert start - 1e6 <= estart <= eend <= end + 1e6, name


def test_recording_leaves_the_step_bitwise_unchanged(two_pass_runs):
    ((_, plain, cls_plain), state_plain), ((_, traced, cls_traced), state_traced), _ = \
        two_pass_runs
    assert {k: float(v) for k, v in plain.items()} == {k: float(v) for k, v in traced.items()}
    assert torch.equal(cls_plain, cls_traced)
    got = dict(state_traced.model.named_parameters())
    for name, p in state_plain.model.named_parameters():
        assert torch.equal(p, got[name]), name


def test_predictor_counts_frames_slots_and_batches_and_spans_each_batch(weights):
    pred = Predictor("UDR18", dict(RATES), state_dict=weights, input_size=SIZE, batch_size=32,
                     dtype=torch.float32, device="cpu")
    assert pred.counts == {"frames": 0, "slots": 0, "batches": 0}
    frames = np.random.default_rng(3).integers(0, 256, (45, SIZE, SIZE, 3), dtype=np.uint8)
    pred.predict_frames(frames[:5])
    assert pred.counts == {"frames": 5, "slots": 32, "batches": 1}
    with recording() as spans:
        probs = pred.predict_frames(frames[5:])
    assert probs.shape == (40,)
    assert pred.counts == {"frames": 45, "slots": 96, "batches": 3}
    assert [s[0] for s in spans if s[3] == -1] == ["ud.serve.request"]
    assert [s[0] for s in _children(spans, 0)] == ["ud.serve.stage", "ud.serve.forward"] * 2
    assert len(spans) == 5
