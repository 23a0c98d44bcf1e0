"""The port's FE engine (unidefense_torch/engines) on the CPU: UDR18 at 32²,
2 real + 2 fake, fp32, on a synthetic FF++ tree. The lifecycle (train,
validate, best and latest checkpoints, resume, test), bitwise resume, the
preemption stop, the profiler option, validation scores against the JAX
ForgeryEngine's from the same weights, and the CLI."""

import copy
import glob
import json
import os
import signal
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_data import jax_native, udjpeg, write_ffpp  # noqa: F401 (fixtures)
from tests.test_torch_models import _randomise
from tests.test_torch_resnet import _scaled
from tests.torch_tmp import drop_tmp_path  # noqa: F401 (autouse fixture)
from unidefense_torch import main as tmain
from unidefense_torch.checkpoint import load_params_only, save_params_only
from unidefense_torch.config import arg_parser
from unidefense_torch.engines import get_engine
from unidefense_torch.models.convert import state_dict_from_jax
from unidefense_torch.utils.metrics import cal_metrics
from unidefense_tpu.config import arg_parser as jax_arg_parser

TRANSFORMS = [
    {"name": "Resize", "params": {"height": 32, "width": 32}},
    {"name": "HorizontalFlip", "params": {"p": 0.5}},
    {"name": "Normalize", "params": {"mean": [0.5] * 3, "std": [0.5] * 3}},
]


@pytest.fixture(autouse=True)
def _keep_stdout(monkeypatch):
    # the engines tee stdout into their run directory
    monkeypatch.setattr(sys, "stdout", sys.stdout)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the steps are many small ops: beside the other test workers, more
    # intra-op threads only wait on each other
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ffpp(tmp_path_factory):
    return write_ffpp(tmp_path_factory.mktemp("ffpp"), videos=4, frames=4)


def _data_yml(path, root, **kw):
    ds = {"root": root, "name": "FFpp", "use_lmdb": False, "real_method": ["Origin"],
          "fake_method": ["Deepfakes"], "compression": "c23", "num_steps": 4, "log_steps": 2,
          "val_steps": 2, "train_transforms": TRANSFORMS,
          "val_transforms": [TRANSFORMS[0], TRANSFORMS[2]],
          "test_transforms": [TRANSFORMS[0], TRANSFORMS[2]]}
    ds.update(kw)
    with open(path, "w") as f:
        yaml.safe_dump(ds, f)
    return str(path)


@pytest.fixture
def fe_config(tmp_path, ffpp, monkeypatch):
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    return {
        "model": {"name": "UDR18", "num_classes": 2, "drop_rate": 0.2, "extractor": "resnet18",
                  "extractor_weights": "ckpt/resnet18.pth"},
        "config": {
            "local_rank": 0, "num_devices": 1,
            "lambda_triplet": 0.1, "lambda_recons": 0.1, "lambda_freq": 1.0,
            "lambda_mask": 0.1, "lambda_fac": 0.1,
            "optimizer": {"name": "adamw", "lr": 1e-3, "betas": [0.9, 0.999],
                          "weight_decay": 5e-6, "amsgrad": True},
            "scheduler": {"name": "StepLR", "step_size": 3, "gamma": 0.5},
            "crop": "nocrop", "warmup_step": 0, "resume": False, "id": "pytest-run",
            "debug": False, "offline": True,
        },
        "data": {"train_batch_size": 2, "val_batch_size": 32, "test_batch_size": 32,
                 "num_workers": 1, "file": _data_yml(tmp_path / "data.yml", ffpp)},
        "cfg_path": str(tmp_path / "data.yml"),
    }


def _engine(cfg, stage="Train", **config):
    cfg = copy.deepcopy(cfg)
    cfg["config"].update(config)
    return get_engine("FE")(cfg, stage=stage, device="cpu")


def _with_steps(cfg, tmp, **kw):
    out = copy.deepcopy(cfg)
    out["data"]["file"] = _data_yml(os.path.join(tmp, f"data-{kw['num_steps']}.yml"),
                                    yaml.safe_load(open(cfg["data"]["file"]))["root"], **kw)
    return out


def test_forgery_engine_lifecycle(fe_config, capsys):
    engine = _engine(fe_config)
    engine.train()
    run_dir = engine.run_dir
    assert engine.state.step == 4
    lines = [json.loads(x) for x in open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [x["step"] for x in lines if "train/acc" in x] == [2, 4]
    assert [x["step"] for x in lines if "val/AUC" in x] == [2, 4]
    assert engine.ckpt.exists(best=False) and engine.ckpt.exists(best=True)
    assert 0.0 <= engine.best_auc <= 1.0
    assert json.load(open(os.path.join(run_dir, "ckpt", "latest.meta.json")))["step"] == 4
    assert os.path.exists(os.path.join(run_dir, "code", "forgery.py"))
    out = capsys.readouterr().out
    assert "Train Iter (4/4)" in out and "Eval Step 4" in out and "Best Step" in out
    assert "WARNING: extractor_weights 'ckpt/resnet18.pth' not found" in out

    engine.log_recon_figure(engine.val_set, {"crop": "nocrop"}, 4, every=2)
    assert os.path.exists(os.path.join(run_dir, "recon_step4.png"))
    with pytest.MonkeyPatch.context() as mp:  # a GPU host without matplotlib
        mp.setattr("importlib.util.find_spec", lambda name: None)
        engine.log_recon_figure(engine.val_set, {"crop": "nocrop"}, 6, every=2)
    assert not os.path.exists(os.path.join(run_dir, "recon_step6.png"))
    assert "skipped: matplotlib is not installed" in capsys.readouterr().out

    state_dict, meta = engine.ckpt.restore_serving(best=False)
    assert meta["step"] == 4
    for k, v in engine.state.model.state_dict().items():
        np.testing.assert_array_equal(state_dict[k].numpy(), v.numpy(), err_msg=k)
    save_params_only(os.path.join(run_dir, "params.pt"), engine.state.model)
    assert load_params_only(os.path.join(run_dir, "params.pt")).keys() == state_dict.keys()

    resumed = _engine(fe_config, resume=True)
    assert resumed.start_step == 5 and resumed.state.step == 4
    assert "Resumed from step 4" in capsys.readouterr().out

    metrics = _engine(fe_config, "Test").test()
    assert 0.0 <= metrics["AUC"] <= 1.0 and metrics["NumP"] + metrics["NumN"] == 32
    assert "Test | EER" in capsys.readouterr().out


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k].numpy(), sb[k].numpy(), err_msg=k)
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    assert list(a.opt_state.slots) == list(b.opt_state.slots) == ["mu", "nu", "nu_max"]
    for field in ("mu", "nu", "nu_max"):
        fa, fb = a.opt_state.slots[field], b.opt_state.slots[field]
        assert set(fa) == set(fb) and fa
        for k in fa:
            np.testing.assert_array_equal(fa[k].numpy(), fb[k].numpy(), err_msg=f"{field} {k}")


def test_resume_is_bitwise(fe_config, tmp_path):
    """3 straight steps equal 1 step, a resume, and 2 more: the weights,
    the BatchNorm statistics, the optimizer state and the step. The step's
    draws are indexed by the step, the data stream fast-forwards (one frame
    a video, 4 a stream: a new epoch at step 3), and the checkpoint carries
    the whole state (StepLR halves the LR at step 3)."""
    cfg = _with_steps(fe_config, tmp_path, num_steps=3, val_steps=1, log_steps=1, train_fpv=1)
    cfg["config"]["scheduler"]["step_size"] = 2
    straight = _engine(cfg, id="straight-3")
    straight.train()
    assert straight.state.step == 3 and len(straight.train_real_set) == 4

    crashy = _engine(cfg, id="crashy-3")
    crashy.num_steps = 1  # stopped after the step-1 validation's checkpoint
    crashy.train()
    assert crashy.state.step == 1

    resumed = _engine(cfg, id="crashy-3", resume=True)
    assert resumed.start_step == 2
    _assert_states_equal(resumed.state, crashy.state)
    resumed.train()
    _assert_states_equal(resumed.state, straight.state)


def test_resume_without_its_sidecar_takes_the_step_from_the_checkpoint(fe_config):
    """A kill between a save's last two renames leaves the checkpoint
    without its sidecar: the resume continues from the step in model.pt."""
    engine = _engine(fe_config, id="no-sidecar")
    engine.state.step = 3
    engine.ckpt.save(engine.state, engine._meta(3))
    os.remove(os.path.join(engine.run_dir, "ckpt", "latest.meta.json"))
    resumed = _engine(fe_config, id="no-sidecar", resume=True)
    assert resumed.start_step == 4 and resumed.state.step == 3


def test_preemption_stops_and_resumes(fe_config, tmp_path):
    cfg = _with_steps(fe_config, tmp_path, num_steps=3, val_steps=4, log_steps=4)
    prev = signal.getsignal(signal.SIGTERM)
    engine = _engine(cfg, id="preempt")
    tick = engine._profile_tick

    def tick_and_signal(cur_step):
        if cur_step == 2:  # a real signal, off the validation cadence
            os.kill(os.getpid(), signal.SIGTERM)
        tick(cur_step)

    engine._profile_tick = tick_and_signal
    engine.train()
    assert engine.state.step == 2
    assert signal.getsignal(signal.SIGTERM) is prev
    with open(os.path.join(engine.run_dir, "ckpt", "latest.meta.json")) as f:
        assert json.load(f)["step"] == 2
    resumed = _engine(cfg, id="preempt", resume=True)
    assert resumed.start_step == 3
    resumed.train()
    assert resumed.state.step == 3


def test_profiler_option_writes_a_trace(fe_config, tmp_path):
    cfg = _with_steps(fe_config, tmp_path, num_steps=2, val_steps=10, log_steps=10)
    engine = _engine(cfg, id="profile", profile_start_step=1, profile_steps=1)
    engine.train()
    files = glob.glob(os.path.join(engine.run_dir, "profile", "**", "*"), recursive=True)
    assert any(os.path.isfile(f) for f in files)


def test_weight_files_follow_jax(fe_config, tmp_path):
    """extractor_weights that exist load into the backbone, and init_weights
    into the whole model after them (loading .pth files is ported; the JAX
    comparison is tests/test_torch_weights.py); missing init_weights is the
    JAX package's FileNotFoundError."""
    from unidefense_torch.models.convert import export_state_dict, save_torch_checkpoint

    source = _engine(fe_config, id="source").state.model
    with torch.no_grad():
        for t in source.state_dict().values():
            if t.is_floating_point():
                t.add_(0.5)
    pth, full = tmp_path / "backbone.pth", tmp_path / "full.bin"
    torch.save(export_state_dict(source, "resnet"), pth)
    save_torch_checkpoint(source, str(full))
    cfg = copy.deepcopy(fe_config)
    cfg["model"]["extractor_weights"] = str(pth)
    got = _engine(cfg, id="weights").state.model.state_dict()
    for k, v in source.state_dict().items():
        assert torch.equal(got[k], v) == k.startswith("extractor.") or \
            k.endswith("num_batches_tracked"), k
    with pytest.raises(FileNotFoundError):
        _engine(fe_config, id="init-missing", init_weights=str(tmp_path / "none.pth"))
    got = _engine(fe_config, id="init", init_weights=str(full)).state.model.state_dict()
    for k, v in source.state_dict().items():
        assert torch.equal(got[k], v), k


def _spread_bottleneck(engine, v, load_kwargs=None):
    """Set the bottleneck's running statistics in ``v`` to the mean and
    variance of its inputs over the validation frames (read by the port's
    model, loaded with ``load_kwargs``), so the probabilities differ per
    frame without saturating."""
    model, val = engine.state.model, engine.val_set
    seen = []
    hook = model.bottleneck.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    frames = val.load_item(val.images, val.targets,
                           **(load_kwargs or {"crop": "nocrop"}))["images"]
    model.eval()
    try:
        engine.eval_step(torch.from_numpy(frames))
    finally:
        hook.remove()
        model.train()
    f = seen[0].double().numpy()
    bn = v["batch_stats"]["bottleneck"]
    bn["mean"], bn["var"] = f.mean(0).astype(np.float32), (f.var(0) + 1e-6).astype(np.float32)


def test_score_dataset_matches_jax_engine(fe_config, jax_native):
    """The validation split scored by the port's engine and by the JAX
    ForgeryEngine (its random validation flips off) from the same weights
    (UDR18, random BatchNorm statistics and scales, a wider classifier; both
    decode through the same libjpeg code): per-video probabilities within
    1e-5 and the same metrics. No JAX train step is compiled."""
    from unidefense_tpu.engines import get_engine as jax_get_engine
    from unidefense_tpu.utils.metrics import cal_metrics as jax_cal_metrics

    jax_engine = jax_get_engine("FE")(copy.deepcopy(fe_config) | {
        "config": dict(fe_config["config"], id="jax-run")}, stage="Train")
    v = {"params": jax.tree.map(np.asarray, jax_engine.state.params),
         "batch_stats": jax.tree.map(np.asarray, jax_engine.state.batch_stats)}
    v = _scaled(_randomise(v, classifier_std=0.05))
    engine = _engine(fe_config, id="port-run")
    engine.state.model.load_state_dict(state_dict_from_jax(v), strict=True)
    _spread_bottleneck(engine, v)
    engine.state.model.load_state_dict(state_dict_from_jax(v), strict=True)
    jax_engine.state = jax_engine.state.replace(params=v["params"],
                                                batch_stats=v["batch_stats"])
    # the JAX engine's eval step preprocesses with the training stage, which
    # flips at random; the port's validates without flips, as val_transforms
    # say: compare without them
    jax_engine.train_real_set.device_tf.hflip_p = 0.0

    got = engine.gather_eval_output(*engine.score_dataset(engine.val_set, 16, {"crop": "nocrop"}, 0))
    ref = jax_engine.gather_eval_output(
        *jax_engine.score_dataset(jax_engine.val_set, 16, {"crop": "nocrop"}, 0))
    assert got["video_tgt"] == ref["video_tgt"] and got["frame_tgt"] == ref["frame_tgt"]
    np.testing.assert_allclose(got["video_prob"], ref["video_prob"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["frame_prob"], ref["frame_prob"], rtol=0, atol=1e-5)
    assert np.ptp(ref["frame_prob"]) > 1e-2  # the frames' probabilities do differ
    m_got = cal_metrics(np.asarray(got["frame_tgt"]), np.asarray(got["frame_prob"]), threshold=0.5)
    m_ref = jax_cal_metrics(np.asarray(ref["frame_tgt"]), np.asarray(ref["frame_prob"]),
                            threshold=0.5)
    for k in ("AUC", "ACC", "NumP", "NumN", "TP_Ratio", "TN_Ratio", "APCER", "BPCER", "EER"):
        assert m_got[k] == pytest.approx(m_ref[k], abs=1e-9), k


def test_assemble_batch_is_one_buffer_real_first():
    """The step's batch: real first, images and labels in one buffer (one
    host-to-device copy on the card)."""
    from unidefense_torch.engines.base import AbstractEngine

    rng = np.random.default_rng(0)
    real, fake = (rng.integers(0, 256, (n, 5, 7, 3), dtype=np.uint8) for n in (3, 2))
    engine = type("E", (), {"device": torch.device("cpu")})()
    batch = AbstractEngine.assemble_batch(engine, real, np.zeros(3, np.int64), fake,
                                          np.ones(2, np.int64))
    np.testing.assert_array_equal(batch["image"].numpy(), np.concatenate([real, fake]))
    assert batch["image"].is_contiguous() and batch["label"].tolist() == [0, 0, 0, 1, 1]
    assert batch["image"].untyped_storage().data_ptr() == \
        batch["label"].untyped_storage().data_ptr()


ARGVS = [
    ["--config", "c.yml"],
    ["--config", "c.yml", "--engine", "FE", "--test", "--offline"],
    ["--config", "c.yml", "--engine", "OCIM", "-r", "0", "--exp_id", "run7",
     "--ds_config", "d.yml", "--num_devices", "1"],
    ["--config", "c.yml", "--engine", "UE", "--local_rank", "2"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[2:]) or "defaults")
def test_cli_parses_the_jax_flags(argv):
    assert vars(arg_parser(argv)) == vars(jax_arg_parser(argv))


def test_cli_refuses_what_is_not_ported(fe_config, tmp_path, monkeypatch):
    """More devices than this host has cards are refused, before a rank
    starts (JAX's create_mesh takes fewer; ROADMAP.md section 3); the
    default engine, UE, is ported and is what runs (here it stops at the
    missing card)."""
    cfg_path = tmp_path / "model.yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump({k: v for k, v in fe_config.items() if k != "cfg_path"}, f)
    with pytest.raises(ValueError, match="num_devices=2 exceeds the 0 CUDA device"):
        tmain.main(["--config", str(cfg_path), "--engine", "FE", "--num_devices", "2"])
    asked = []
    monkeypatch.setattr(tmain, "get_engine", lambda name: asked.append(name) or get_engine(name))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["--config", str(cfg_path)])
    assert asked == ["UE"] and get_engine("UE").__name__ == "UniAttackEngine"
