"""The training input of the port on the CPU: the prefetcher's draws planned
in step order (OCIM's and UE's training batches the same bit for bit on one
decode thread or two, and within a level of the JAX engine's on one), and
the learning tool's tree and run."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from unidefense_torch.data.transforms import LockedRNG
from unidefense_torch.engines import get_engine


@pytest.fixture(autouse=True)
def _keep_stdout(monkeypatch):
    # the engines tee stdout into their run directory
    monkeypatch.setattr(sys, "stdout", sys.stdout)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # engine steps beside the other test workers: more intra-op threads
    # only wait on each other
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the prefetcher

def _reseed(engine):
    """The engine's training streams as a new run starts them: samplers
    re-seeded at step 1, the datasets' and host stages' generators anew."""
    for b in engine._batchers():
        b._it, b._count = None, 0
        b.dataset.rng = LockedRNG(2022)
        b.dataset.host_tf.rng = LockedRNG(5)


def _stream(engine, workers: int, steps: int = 3) -> list:
    """The prefetcher's first ``steps`` batches with ``workers`` decode
    threads, the first decode held back 0.3 s so that the next step's load
    runs ahead of it where there are threads to run it."""
    _reseed(engine)
    engine.data_cfg["num_workers"] = workers
    finish = type(engine._batchers()[0].dataset).finish_item
    first = threading.Event()

    def held(ds, plan):
        if not first.is_set():
            first.set()
            time.sleep(0.3)
        return finish(ds, plan)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(engine._batchers()[0].dataset), "finish_item", held)
        engine.num_steps = steps
        pre = engine._make_prefetcher()
        batches = [{k: v.clone() for k, v in b.items()} for b in pre]
        pre.close()
    return batches


@pytest.fixture(scope="module")
def train_engines(tmp_path_factory):
    """The port's OCIM (4p crops with a drawn margin, RandomResizedCrop) and
    UE (RandomResizedCrop over mixed sources) engines on the CPU, and the
    JAX package's, each from its test file's config."""
    from tests.test_torch_ocim import _config as ocim_config
    from tests.test_torch_ocim import write_fas
    from tests.test_torch_uniattack import _config as ue_config
    from tests.test_torch_uniattack import write_uniattack
    from unidefense_tpu.engines import get_engine as jax_get_engine

    tmp = str(tmp_path_factory.mktemp("prefetch"))
    fas = write_fas(os.path.join(tmp, "fas"))
    ua = write_uniattack(os.path.join(tmp, "ua"))
    cwd, stdout = os.getcwd(), sys.stdout
    os.chdir(tmp)
    try:
        out = {}
        for name, cfg in (("OCIM", lambda r: ocim_config(tmp, fas, r)),
                          ("UE", lambda r: ue_config(tmp, ua, r))):
            out[name] = (get_engine(name)(cfg(f"port-{name}"), stage="Train", device="cpu"),
                         jax_get_engine(name)(cfg(f"jax-{name}"), stage="Train"))
    finally:
        sys.stdout = stdout
        os.chdir(cwd)
    return out


@pytest.mark.parametrize("name", ["OCIM", "UE"])
def test_training_batches_do_not_depend_on_the_decode_threads(train_engines, name):
    """Three steps of the training prefetcher on two decode threads (the
    first decode held back) and on one: the same batches bit for bit, since
    every draw is planned on the consumer thread in step order."""
    engine, _ = train_engines[name]
    two, one = _stream(engine, 2), _stream(engine, 1)
    assert len(two) == len(one) == 3
    for a, b in zip(two, one):
        assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])


@pytest.mark.parametrize("name", ["OCIM", "UE"])
def test_training_batches_match_jax_with_one_worker(train_engines, name):
    """The port's prefetcher and the JAX engine's, both with one decode
    thread, from the same seeds: the same labels, images within 1 level
    (the host library's bicubic against cv2's)."""
    engine, ref = train_engines[name]
    got = _stream(engine, 1)
    _reseed(ref)
    ref.data_cfg["num_workers"] = 1
    ref.num_steps = 3
    pre = ref._make_prefetcher()
    want = [{k: np.asarray(v) for k, v in b.items()} for b in pre]
    pre.close()
    assert len(want) == len(got) == 3
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g["label"].numpy(), r["label"])
        d = np.abs(g["image"].numpy().astype(np.int32) - r["image"].astype(np.int32))
        assert d.max() <= 1, d.max()


def test_learning_tool_writes_an_ffpp_tree_and_runs(tmp_path):
    """The learning tool's tree is read by the port's FF++ dataset (real and
    fake frames, the checkerboard on the fakes only), and ``run`` trains two
    steps at 32² on the CPU and returns a finite AUC."""
    from unidefense_torch.data.datasets import FaceForensics
    from unidefense_torch.tools import validate_learning as vl

    root = str(tmp_path / "ffpp")
    index = vl.make_dataset(root, 32, n_videos=2, frames=2)
    ds = FaceForensics({"root": root, "method": ["Origin", "Deepfakes"], "compression": "c23",
                        "use_lmdb": False, "train_transforms": [], "val_transforms": [],
                        "test_transforms": []}, "test")
    assert len(ds) == len(index) == 8 and sorted(ds.targets) == [0] * 4 + [1] * 4
    real = ds.load_item([str(p) for p, t in index if t == 0][:1], np.zeros(1, np.int64),
                        crop="nocrop")["images"].astype(np.float32)
    fake = ds.load_item([str(p) for p, t in index if t == 1][:1], np.ones(1, np.int64),
                        crop="nocrop")["images"].astype(np.float32)
    # the same blob seed is not shared, so compare the checkerboard's energy:
    # the difference of neighbouring pixels along a row
    rough = [float(np.abs(np.diff(f, axis=2)).mean()) for f in (real, fake)]
    assert rough[1] > rough[0]
    # in a directory of its own that run() removes: each validation writes
    # checkpoints of UDR18
    best_auc, best_acc = vl.run(steps=2, size=32, device="cpu")
    assert np.isfinite(best_auc) and 0.0 <= best_auc <= 1.0 and 0.0 <= best_acc <= 1.0
