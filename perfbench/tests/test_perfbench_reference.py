"""The reference against the program at a tiny size on the CPU, the control
against the program, and whole runs of the harness (its look for a chip
skipped) that must come out not correct when the timed path is broken."""

import copy

import numpy as np
import pytest
import torch

from perfbench import harness, serve_cell, train_cell, weights
from perfbench.reference import model as ref_model
from perfbench.reference.numerics import Numerics
from perfbench.run import run_cell

CPU = torch.device("cpu")
B0 = [1, 3, 5, 8, 11, 15, 16]
B0_RESIDUAL = r"backbone\._blocks\.(2|4|6|7|9|10|12|13|14)\._bn2"


def tiny_config(name="udeb4", precision="fp32", size=64):
    cfg = copy.deepcopy(harness.config(name))
    if name == "udeb4":  # EfficientNet-b0 at UDEB4's other widths: a small twin
        cfg["model"].update(extractor="efficientnet-b0", delimiter=B0)
        cfg["assumed"]["init"]["residual_bn"] = B0_RESIDUAL
    cfg["data"]["input_size"] = size
    cfg["config"]["precision"] = precision
    return cfg


def tiny_train():
    wl = copy.deepcopy(harness.workload("udeb4-train-b32"))
    wl.update(real_per_rank=3, fake_per_rank=3, pool_batches=3, warmup_steps=1, trace_steps=1,
              limits={"logit_gap": 1e-3, "loss_gap": 1e-3, "grad_gap": 1e-3,
                      "grad_gap_median": 1e-3, "change_gap": 3e-2})
    return wl


def tiny_serve():
    wl = copy.deepcopy(harness.workload("udeb4-serve-clips"))
    wl.update(batch_size=4, lengths=[2, 5, 8], rate_per_s=20.0, pool_frames=16,
              warmup_requests=1, calibrate_frames=4, trace_requests=2, check_requests=6,
              limits={"score_gap": 1e-2})
    return wl


@pytest.mark.parametrize("hw", [12, 9])
def test_reference_sfconv_is_the_ports_closed_form(hw):
    from unidefense_torch.ops.sfconv_spatial import sfconv_freq_spatial

    g = torch.Generator().manual_seed(hw)
    x = torch.randn(2, hw, hw, 8, generator=g, dtype=torch.float64)
    w = torch.randn(16, 16, generator=g, dtype=torch.float64) / 4
    ref = ref_model.inverse_spectrum(ref_model.spectrum(x) @ w, (hw, hw))
    # in float64, but the port's Hilbert matrix is stored in float32
    torch.testing.assert_close(ref, sfconv_freq_spatial(x, w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,model", [("udeb4", "UDEB4"), ("udr50", "UDR50")])
def test_reference_forward_is_the_ports(name, model):
    from unidefense_torch.models.registry import build_model

    cfg = tiny_config(name)
    sd = weights.calibrate(cfg, weights.make_state_dict(cfg, 3, CPU), 3, CPU, 64, 4)
    port = build_model(model, {k: v for k, v in cfg["model"].items() if k != "name"},
                       v4_widths=())
    port.load_state_dict(sd, strict=True)
    ref = ref_model.build(cfg["model"], Numerics(), sd, CPU)
    u8 = weights.frames(3, 64, torch.Generator().manual_seed(1), CPU)
    from perfbench.reference.train import frame_scores, normalize
    from unidefense_torch.device import nchw

    with torch.no_grad():
        got = port.eval()(nchw(normalize(u8)))["cls_out"]
    want = ref.eval()(ref_model.nchw(normalize(u8)))["cls_out"]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert frame_scores(ref, u8).std() > 1e-3  # the weights keep the frames apart


def _train_readings(precision):
    cfg, wl = tiny_config(precision=precision), tiny_train()
    sd = weights.make_state_dict(cfg, 5, CPU)
    state, step = train_cell.build_program(cfg, wl, sd, CPU)
    feed = train_cell.Feed(step, state, train_cell.pool(5, 0, wl, cfg, CPU), wl, 5, 0, CPU)
    got = train_cell.first_steps(feed, wl["check_steps"], keep=True)
    ref = train_cell.reference_steps(cfg, wl, 5, CPU, Numerics())
    ctl = train_cell.reference_steps(cfg, wl, 5, CPU, Numerics(fp8=True))
    return train_cell.gaps(got, ref), train_cell.gaps(ctl, ref)


def test_control_reads_far_above_the_program():
    """bfloat16 program against float8 control: the control reads three
    times the program or more on at least one number."""
    prog, ctl = _train_readings("bf16")
    assert max(ctl[k] / prog[k] for k in prog) >= 3, (prog, ctl)
    cfg, wl = tiny_config(precision="bf16"), tiny_serve()
    sd = serve_cell.served_weights(cfg, wl, 5, CPU)
    frames = serve_cell.frame_pool(cfg, wl, 5, CPU)
    requests = [r for _, r in zip(range(6), serve_cell.schedule(wl, 5))]
    ref = serve_cell.reference_scores(cfg, sd, frames, requests, CPU, Numerics())
    pred = serve_cell.build_program(cfg, wl, sd, CPU)
    got = [r[2] for r in serve_cell.serve(pred, frames, requests)[0]]
    ctl = serve_cell.reference_scores(cfg, sd, frames, requests, CPU, Numerics(fp8=True))
    assert serve_cell.score_gap(ctl[0], ref) >= 3 * serve_cell.score_gap(got, ref)


def _unchanged(monkeypatch):
    from unidefense_torch.train import optim

    monkeypatch.setattr(optim.Adam, "update", lambda self, model, state, lr_scale=None: None)


def _half_batch(monkeypatch):
    from unidefense_torch.train import step

    orig = step._shared_losses

    def half(out, labels, sum_real, sum_fake):
        r, f = sum_real // 2, sum_fake // 2
        idx = torch.cat([torch.arange(r), sum_real + torch.arange(f)]).to(labels.device)
        ld = {k: ([t[idx] for t in v] if isinstance(v, list) else v[idx])
              for k, v in out["loss_dict"].items()}
        return orig({"cls_out": out["cls_out"][idx], "loss_dict": ld}, labels[idx], r, f)

    monkeypatch.setattr(step, "_shared_losses", half)


def _altered_answer(monkeypatch):
    from unidefense_torch.inference import Predictor

    orig = Predictor.predict_frames

    def altered(self, frames):
        p = orig(self, frames).copy()
        p[0] = min(1.0, p[0] + 0.5) if p[0] < 0.5 else p[0] - 0.5
        return p

    monkeypatch.setattr(Predictor, "predict_frames", altered)


def _half_frames(monkeypatch):
    from unidefense_torch.inference import Predictor

    monkeypatch.setattr(Predictor, "predict_video",
                        lambda self, f: float(self.predict_frames(f[: max(1, len(f) // 2)])
                                              .mean()))


@pytest.mark.parametrize("cell,fault", [
    ("udeb4-train-b32", None), ("udeb4-train-b32", _unchanged),
    ("udeb4-train-b32", _half_batch),
    ("udeb4-serve-clips", None), ("udeb4-serve-clips", _altered_answer),
    ("udeb4-serve-clips", _half_frames)],
    ids=["train", "train-unchanged-state", "train-half-batch", "serve",
         "serve-altered-answer", "serve-half-frames"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    wl = tiny_train() if "train" in cell else tiny_serve()
    if fault is not None:
        fault(monkeypatch)
    got = run_cell(cell, 2**31 + 12345, 0.5, False, device="cpu", wl=wl, cfg=tiny_config())
    assert got["correct"] is (fault is None), got["checks"]
    assert got["attempted"] >= 1 and got["failed"] == 0
    assert "setup_s" in got["metrics"] and len(got["metrics"]) >= 2


@pytest.mark.chip
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = run_cell("udeb4-train-b32", 2**31 + 7, 2.0, False, device="cuda",
                   wl=tiny_train(), cfg=tiny_config(precision="bf16"))
    assert got["correct"], got["checks"]
    assert np.isfinite(got["metrics"]["train_img_per_s"]["value"])


def no_exchange_entry(*args):
    """A rank whose step leaves out the exchange between cards: no synced
    BatchNorm, no gradient mean."""
    from unidefense_torch.parallel import mesh
    from unidefense_torch.train import step

    step.mean_gradients = lambda model, group: None
    mesh.sync_batchnorm = lambda model, group: model
    train_cell.rank_entry(*args)


@pytest.mark.parametrize("entry", [train_cell.rank_entry, no_exchange_entry],
                         ids=["dp", "dp-no-exchange"])
def test_data_parallel_run_on_two_cpu_ranks(monkeypatch, entry):
    """Two gloo ranks against the reference over both ranks' rows; the same
    run with the exchange left out is not correct."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks share this machine's cores
    wl = tiny_train()
    wl["chips"] = 2
    got = train_cell.run("udeb4-train-dp4", wl, tiny_config(), 2**31 + 99, 0.5, False, CPU,
                         0.0, entry=entry)
    correct, checks = harness.judge(got["numbers"], wl["limits"])
    assert correct is (entry is train_cell.rank_entry), checks
