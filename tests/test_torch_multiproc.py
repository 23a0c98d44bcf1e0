"""The port's engines across two ranks on the CPU: gloo processes spawned
by ``parallel.launch`` running ``unidefense_torch.main.run`` (what ``main
--num_devices 2`` spawns; tests/torch_ranks.engine_run records each rank),
and ``main(..., "--num_devices", "2"], device="cpu")`` itself. UDR18 at
32², 1 real + 1 fake per rank (tests/test_multihost.py:179-589 and
tests/test_engine.py:95-110,228-275 for the JAX package): the ranks stop
together on a one-sided preemption, agree bitwise, shard their streams as
JAX's per-process samplers do, merge their validation stripes into what one
process scores, and resume 2 -> 1 -> 2 ranks bitwise; OCIM and UE; a
failing rank ends the run."""

import json
import os
import time

import numpy as np
import pytest
import torch
import yaml

from tests import torch_ranks
from tests.test_torch_data import write_ffpp
from tests.test_torch_engine import TRANSFORMS, _keep_stdout, _one_thread  # noqa: F401
from tests.test_torch_ocim import _config as _ocim_config
from tests.test_torch_ocim import write_fas
from tests.test_torch_uniattack import _config as _ue_config
from tests.test_torch_uniattack import write_uniattack
from tests.torch_tmp import drop_tmp_path, module_tmp  # noqa: F401 (autouse fixture)
from unidefense_torch import main as tmain
from unidefense_torch.engines import get_engine
from unidefense_torch.parallel import launch
from unidefense_torch.utils.metrics import cal_metrics
from unidefense_tpu.data.pipeline import EpochSampler as JaxEpochSampler

WORLD = 2


@pytest.fixture(autouse=True)
def _one_thread_per_rank(monkeypatch):
    # the spawned ranks read it when torch starts, before they set it themselves
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _yml(path, cfg: dict) -> str:
    with open(path, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.items() if k != "cfg_path"}, f)
    return str(path)


def _fe_yml(tmp, root, run_id, num_steps=4, resume=False, num_devices=WORLD) -> str:
    """FE on UDR18 at 32², 1 real + 1 fake per rank, validated every 2 steps
    (b4), the preemption flags agreed every 2."""
    ds = {"root": root, "name": "FFpp", "use_lmdb": False, "real_method": ["Origin"],
          "fake_method": ["Deepfakes"], "compression": "c23", "num_steps": num_steps,
          "log_steps": 2, "val_steps": 2, "train_transforms": TRANSFORMS,
          "val_transforms": [TRANSFORMS[0], TRANSFORMS[2]],
          "test_transforms": [TRANSFORMS[0], TRANSFORMS[2]]}
    data = os.path.join(tmp, f"data-{run_id}-{num_steps}.yml")
    with open(data, "w") as f:
        yaml.safe_dump(ds, f)
    cfg = {
        "model": {"name": "UDR18", "num_classes": 2, "drop_rate": 0.2, "extractor": "resnet18"},
        "config": {"num_devices": num_devices, "lambda_triplet": 0.1, "lambda_recons": 0.1,
                   "lambda_freq": 1.0, "lambda_mask": 0.1, "lambda_fac": 0.1,
                   "optimizer": {"name": "adamw", "lr": 1e-3, "betas": [0.9, 0.999],
                                 "weight_decay": 5e-6, "amsgrad": True},
                   "crop": "nocrop", "warmup_step": 0, "resume": resume, "id": run_id,
                   "debug": False, "offline": True, "preempt_sync_steps": 2},
        "data": {"train_batch_size": 1, "val_batch_size": 4, "test_batch_size": 4,
                 "num_workers": 1, "file": data},
    }
    return _yml(os.path.join(tmp, f"model-{run_id}-{num_steps}-{num_devices}-{resume}.yml"), cfg)


def _argv(yml, engine="FE"):
    return ["--config", yml, "--engine", engine, "--offline"]


def _assert_shards_as_jax(ranks):
    """Each rank's samplers: shard rank of WORLD, and the first epoch JAX's
    per-process EpochSampler with the same settings draws."""
    for r, res in enumerate(ranks):
        assert res["rank"] == r and res["world"] == WORLD
        for shard, epoch in zip(res["shards"], res["first_epoch"]):
            assert (shard["shard_id"], shard["num_shards"]) == (r, WORLD)
            want = JaxEpochSampler(shard["dataset_len"], shard["batch_size"], shuffle=True,
                                   drop_last=shard["drop_last"], pad_last=shard["pad_last"],
                                   shard_id=r, num_shards=WORLD)
            want.set_epoch(0)
            assert epoch == [b.tolist() for b in want]


# ----------------------------------------------------------------------- FE

@pytest.fixture(scope="module")
def fe_run(tmp_path_factory):
    """Two ranks, 4 steps asked, rank 1 alone flagged for preemption at
    step 1: both must stop at step 2, the first sync boundary."""
    with module_tmp(tmp_path_factory, "fe-dp") as tmp:
        root = write_ffpp(tmp / "ffpp", videos=4, frames=4)
        work = tmp / "work"
        work.mkdir()
        out = tmp / "out"
        out.mkdir()
        yml = _fe_yml(str(tmp), root, "dp-run")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OMP_NUM_THREADS", "1")
            ranks = torch_ranks.spawn(torch_ranks.engine_run, str(out), str(work), _argv(yml),
                                      1, True)
        yield tmp, root, work, ranks


def test_fe_ranks_stop_together_on_a_one_sided_preemption(fe_run):
    _, _, work, ranks = fe_run
    assert [r["step"] for r in ranks] == [2, 2]
    run_dir = os.path.join(work, ranks[0]["run_dir"])
    with open(os.path.join(run_dir, "ckpt", "latest.meta.json")) as f:
        assert json.load(f)["step"] == 2
    with open(os.path.join(run_dir, "records.txt")) as f:
        records = f.read()
    # rank 0 alone prints and tees
    assert records.count("Preemption requested") == 1 and records.count("Eval Step 2") == 1


def test_fe_ranks_agree_bitwise_and_rank0_writes(fe_run):
    _, _, work, ranks = fe_run
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["built"] == ranks[1]["built"]
    assert ranks[0]["best"] == ranks[1]["best"] and 0.0 <= ranks[0]["best"]["best_auc"] <= 1.0
    run_dir = os.path.join(work, ranks[0]["run_dir"])
    assert os.path.isdir(os.path.join(run_dir, "ckpt", "best"))
    assert sorted(os.listdir(os.path.join(run_dir, "ckpt"))) == [
        "best", "best.meta.json", "latest", "latest.meta.json"]


def test_fe_streams_shard_as_jax(fe_run):
    _assert_shards_as_jax(fe_run[3])


def test_fe_merged_validation_equals_one_process(fe_run):
    """The stripes of step 2's validation, merged on each rank, against one
    process scoring the whole split from the checkpoint of step 2 (restored
    bitwise): every frame scored once, the same probabilities per frame
    within 1e-6 (the stripes batch the frames otherwise), and the same
    metrics."""
    tmp, root, work, ranks = fe_run
    merged = [r["merged"][-1] for r in ranks]
    assert merged[0] == merged[1]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cfg = yaml.safe_load(open(_fe_yml(str(tmp), root, "dp-run", resume=True, num_devices=1)))
        one = get_engine("FE")(cfg, device="cpu")
        assert torch_ranks.state_digest(one.state) == ranks[0]["digest"]
        want = one.gather_eval_output(*one.score_dataset(one.val_set, 4, {"crop": "nocrop"}, 2))
    finally:
        os.chdir(cwd)
    got = merged[0]
    assert len(got["frame_prob"]) == len(one.val_set)
    for key in ("frame_prob", "video_prob"):
        np.testing.assert_allclose(sorted(got[key]), sorted(want[key]), rtol=0, atol=1e-6)
    mg = cal_metrics(np.asarray(got["frame_tgt"]), np.asarray(got["frame_prob"]), threshold=0.5)
    mw = cal_metrics(np.asarray(want["frame_tgt"]), np.asarray(want["frame_prob"]), threshold=0.5)
    for k in ("AUC", "ACC", "EER"):
        assert abs(mg[k] - mw[k]) <= 1e-6, k


def test_fe_elastic_resume_two_to_one_to_two(fe_run):
    """The checkpoint of two ranks (step 2) resumes in one process, bitwise,
    which trains to step 4; that checkpoint resumes on two ranks, bitwise on
    each, which train to step 6 and agree."""
    tmp, root, work, ranks = fe_run
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cfg = yaml.safe_load(open(_fe_yml(str(tmp), root, "dp-run", resume=True, num_devices=1)))
        one = get_engine("FE")(cfg, device="cpu")
        assert one.n_dev == 1 and torch_ranks.state_digest(one.state) == ranks[0]["digest"]
        one.train()
        assert one.state.step == 4
        at_four = torch_ranks.state_digest(one.state)
    finally:
        os.chdir(cwd)
    out = tmp / "out-resumed"
    out.mkdir()
    again = torch_ranks.spawn(torch_ranks.engine_run, str(out), str(work),
                              _argv(_fe_yml(str(tmp), root, "dp-run", num_steps=6, resume=True)))
    assert [r["built"] for r in again] == [at_four, at_four]
    assert [r["step"] for r in again] == [6, 6] and again[0]["digest"] == again[1]["digest"]


def test_main_spawns_the_ranks(tmp_path):
    """``main(argv + ["--num_devices", "2"], device="cpu")`` trains on two
    ranks and returns None; rank 0 alone writes the run's lines and its
    checkpoints."""
    root = write_ffpp(tmp_path / "ffpp", videos=2, frames=2)
    work = tmp_path / "work"
    work.mkdir()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        yml = _fe_yml(str(tmp_path), root, "cli", num_steps=2, num_devices=1)
        assert tmain.main(_argv(yml) + ["--num_devices", "2"], device="cpu") is None
    finally:
        os.chdir(cwd)
    run_dir = work / "runs" / "UDR18" / "cli"
    records = (run_dir / "records.txt").read_text()
    assert records.count("Train Iter (2/2)") == 1 and records.count("Eval Step 2") == 1
    assert (run_dir / "ckpt" / "best").is_dir() and (run_dir / "ckpt" / "latest").is_dir()


# -------------------------------------------------------------- OCIM and UE

def test_ocim_across_ranks(tmp_path):
    """OCIM, 2 steps and one validation on two ranks: four domain streams
    sharded as JAX's, the video-level metrics from the merged stripes, the
    ranks bitwise equal."""
    root = write_fas(str(tmp_path / "fas"))
    work, out = tmp_path / "work", tmp_path / "out"
    work.mkdir()
    out.mkdir()
    cfg = _ocim_config(str(tmp_path), root, "ocim-dp", val_steps=2)
    cfg["config"]["num_devices"] = WORLD
    cfg["data"]["train_batch_size"] = 1
    ranks = torch_ranks.spawn(torch_ranks.engine_run, str(out), str(work),
                              _argv(_yml(tmp_path / "ocim.yml", cfg), "OCIM"), None, True)
    assert [r["step"] for r in ranks] == [2, 2] and len(ranks[0]["shards"]) == 4
    assert ranks[0]["digest"] == ranks[1]["digest"] and ranks[0]["best"] == ranks[1]["best"]
    assert ranks[0]["merged"] == ranks[1]["merged"] and len(ranks[0]["merged"]) == 1
    _assert_shards_as_jax(ranks)


def test_uniattack_across_ranks(tmp_path):
    """UE, 2 steps and one validation on two ranks: the frame-EER threshold
    of the merged validation stripes, and every best metric, equal on both
    ranks; the streams sharded as JAX's; the ranks bitwise equal."""
    roots = write_uniattack(str(tmp_path / "ua"))
    work, out = tmp_path / "work", tmp_path / "out"
    work.mkdir()
    out.mkdir()
    cfg = _ue_config(str(tmp_path), roots, "ue-dp", val_steps=2)
    cfg["config"]["num_devices"] = WORLD
    cfg["data"]["train_batch_size"] = 1
    ranks = torch_ranks.spawn(torch_ranks.engine_run, str(out), str(work),
                              _argv(_yml(tmp_path / "ue.yml", cfg), "UE"), None, True)
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[0]["best"] == ranks[1]["best"] and ranks[0]["best"]["best_thres"] == \
        ranks[1]["best"]["best_thres"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert len(ranks[0]["merged"]) == 3 and ranks[0]["merged"] == ranks[1]["merged"]
    _assert_shards_as_jax(ranks)


# ------------------------------------------------------------------ failure

def test_a_failing_rank_ends_the_run(tmp_path):
    """Rank 1 raises while rank 0 waits at a barrier: the launcher raises
    the first failure it sees (rank 1's, or rank 0's barrier losing its
    peer) and no rank is left running (within 60 s, of the launcher's
    120)."""
    t0 = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="Process [01] terminated"):
        launch(torch_ranks.fail_on_rank_one, WORLD, args=(str(tmp_path),), device="cpu",
               timeout=120)
    assert time.monotonic() - t0 < 60
    assert not os.path.exists(tmp_path / "rank0.pt")


def test_main_raises_when_its_ranks_fail(tmp_path):
    """``main`` with two ranks whose data root does not exist raises (a
    ``python -m unidefense_torch.main`` run exits non-zero)."""
    yml = _fe_yml(str(tmp_path), str(tmp_path / "missing"), "fails", num_steps=2)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with pytest.raises(Exception, match="terminated|Error"):
            tmain.main(_argv(yml) + ["--num_devices", "2"], device="cpu")
    finally:
        os.chdir(cwd)
