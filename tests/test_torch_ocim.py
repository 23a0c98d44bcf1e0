"""The port's OCIM path (unidefense_torch) against the JAX package's on the
CPU, on a synthetic face anti-spoofing tree (FrameStore blobs under the
``_crop`` keys, 5-point list pickles): the RandomResizedCrop boxes, the host
library's bicubic resize and its header reader, the OCIM datasets, the
loaded items (4p crops with a drawn margin, RandomResizedCrop), the
engine's multi-stream batches and validation scores, and the engine's
lifecycle through the CLI, its resumed selection stream included."""

import copy
import functools
import os
import sys

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_data import jax_native, udjpeg  # noqa: F401 (fixtures)
from tests.test_torch_engine import _spread_bottleneck
from tests.test_torch_models import _randomise
from tests.test_torch_resnet import _scaled
from tests.torch_tmp import drop_tmp_path, module_tmp  # noqa: F401 (autouse fixture)
from unidefense_torch import main as tmain
from unidefense_torch.data import datasets as tds
from unidefense_torch.data import native as tnative
from unidefense_torch.data import transforms as ttf
from unidefense_torch.data.store import FrameStoreWriter
from unidefense_torch.engines import get_engine
from unidefense_torch.models.convert import state_dict_from_jax
from unidefense_torch.utils.metrics import cal_metrics
from unidefense_tpu.data import datasets as jds
from unidefense_tpu.data import transforms as jtf

DOMAINS = {"O": "Oulu_NPU", "C": "CASIA_database", "M": "MSU-MFSD"}
FRAME = (60, 76)  # (H, W) of every frame
RRC = {"name": "RandomResizedCrop",
       "params": {"height": 32, "width": 32, "interpolation": 2, "p": 1.0, "scale": [0.2, 1.0]}}
NORM = {"name": "Normalize", "params": {"mean": [0.5] * 3, "std": [0.5] * 3}}
TRAIN_TF = [RRC, {"name": "HorizontalFlip", "params": {"p": 0.5}}, NORM]
TEST_TF = [{"name": "Resize", "params": {"height": 32, "width": 32}}, NORM]


@pytest.fixture(autouse=True)
def _keep_stdout(monkeypatch):
    # the engines tee stdout into their run directory
    monkeypatch.setattr(sys, "stdout", sys.stdout)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # many small ops beside the other test workers: more intra-op threads
    # only wait on each other
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_fas(root, videos=3, frames=3):
    """One FrameStore and two 5-point lists per domain: `videos` real and
    fake videos of `frames` q95 JPEG frames (cv2.imencode) of smoothed
    seeded noise, each with a 26x30 face box at a seeded position, every
    third within 5 px of an edge so that a margin crosses the frame."""
    rng = np.random.default_rng(7)
    h, w = FRAME
    for dom in DOMAINS.values():
        os.makedirs(os.path.join(root, dom, "lists"), exist_ok=True)
        with FrameStoreWriter(os.path.join(root, "lmdb", f"{dom}.udb")) as store:
            for label in ("real", "fake"):
                items = []
                for v in range(videos):
                    for f in range(frames):
                        rel = f"{dom}/videos/{label}_{v}/{f:03d}.jpg"
                        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                                               (3, 3), 0)
                        store.add(rel.replace(dom, f"{dom}_crop"),
                                  cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1]
                                  .tobytes())
                        bw, bh = 26, 30
                        if (v + f) % 3 == 0:  # at the left and bottom edges
                            x = int(rng.integers(0, 5))
                            y = int(rng.integers(h - bh - 4, h - bh + 1))
                        else:
                            x = int(rng.integers(5, w - bw - 5))
                            y = int(rng.integers(5, h - bh - 5))
                        items.append(f"{rel} 0 {x} {y} {bw} {bh}")
                torch.save(items, os.path.join(root, dom, "lists", f"{label}_5points.pickle"))
    return str(root)


@pytest.fixture(scope="module")
def fas(tmp_path_factory):
    return write_fas(tmp_path_factory.mktemp("fas"))


def _options(root, **kw):
    opts = {"root": root, "use_lmdb": True, **{f"{k}_root": v for k, v in DOMAINS.items()},
            "train_dataset": ["O", "C"], "dev_dataset": ["M"], "test_dataset": ["M"],
            "num_steps": 2, "log_steps": 1, "val_steps": 1, "train_transforms": TRAIN_TF,
            "dev_transforms": TEST_TF, "test_transforms": TEST_TF}
    opts.update(kw)
    return opts


# ---------------------------------------------------------- transforms


def _box_of(view, frame):
    """(x1, y1, x2, y2) of a numpy view inside ``frame``."""
    off = view.__array_interface__["data"][0] - frame.__array_interface__["data"][0]
    y, rest = divmod(off, frame.strides[0])
    x = rest // frame.strides[1]
    return x, y, x + view.shape[1], y + view.shape[0]


@pytest.mark.parametrize("params", [
    {"scale": [0.2, 1.0], "p": 1.0},
    {"scale": [0.08, 1.0], "p": 0.5},
    {"scale": [0.5, 0.9], "ratio": [0.5, 2.0], "p": 0.7},
], ids=["ocim", "default-scale-p0.5", "wide-ratio"])
def test_rrc_boxes_match_jax(params):
    """The port's boxes and the JAX stage's crops from the same seed, equal
    over 300 frame sizes (thin frames take the centre-crop fallback), the
    draw against p included."""
    cfg = [{"name": "RandomResizedCrop", "params": {"height": 8, "width": 8, **params}}]
    port, _ = ttf.build_transforms(cfg)
    ref, _ = jtf.build_transforms(cfg)
    seen = []
    ref._random_resized_crop = _recording(ref._random_resized_crop, seen)
    sizes = np.random.default_rng(3).integers(1, 90, (300, 2))
    sizes[:20, 0] = 2  # 2 x w: no try fits, the fallback crops the centre
    fb_w = int(round(2 * params.get("ratio", [0.75, 4 / 3])[1]))  # its width at h 2
    fallbacks = 0
    for h, w in sizes.tolist():
        frame = np.zeros((h, w, 3), np.uint8)
        before = len(seen)
        ref(frame)
        want = seen[-1] if len(seen) > before else (0, 0, w, h)
        assert port.crop_box(h, w) == want, (h, w)
        x = (w - fb_w) // 2
        fallbacks += h == 2 and w > 4 * fb_w and want == (x, 0, x + fb_w, 2)
    assert fallbacks > 0 and len(seen) > 0


def _recording(crop, seen):
    """``crop`` that also records the box of each crop it returns."""
    def rrc(img):
        out = crop(img)
        seen.append(_box_of(out, img))
        return out
    return rrc


def test_rrc_settings_and_refusals():
    host, dev = ttf.build_transforms(TRAIN_TF)
    ref, jdev = jtf.build_transforms(TRAIN_TF)
    for k in ("height", "width", "rrc_scale", "rrc_ratio", "rrc_p", "interpolation"):
        assert getattr(host, k) == getattr(ref, k), k
    assert dev.hflip_p == jdev.hflip_p == 0.5
    host, _ = ttf.build_transforms(TEST_TF)
    assert host.rrc_scale is None and host.crop_box(5, 7) == (0, 0, 7, 5)
    for code in (0, 3, 4):
        bad = [{"name": "RandomResizedCrop", "params": dict(RRC["params"], interpolation=code)}]
        with pytest.raises(NotImplementedError, match="interpolation"):
            ttf.build_transforms(bad)
    with pytest.raises(NotImplementedError, match="interpolation"):
        tnative.decode_batch([b"\xff\xd8"], None, 4, 4, interp=3)


# ----------------------------------------------------- the host library


def _jpeg(h, w, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()


# (frame H, W), crop box (x1, y1, x2, y2) or None, output (H, W)
CUBIC_CASES = [
    ((97, 120), None, (256, 256)),
    ((61, 77), (0, 0, 31, 45), (64, 64)),            # up, touching the top left
    ((61, 77), (40, 20, 77, 61), (16, 24)),          # down, touching the bottom right
    ((120, 98), (3, 7, 98, 119), (37, 53)),          # down, odd sizes
    ((33, 29), (-5, -3, 40, 50), (35, 31)),          # a box the frame clamps
    ((50, 50), (10, 10, 42, 42), (32, 32)),          # no resize: a copy
    ((9, 13), None, (70, 41)),                       # up fivefold
]


@pytest.mark.parametrize("frame,box,out", CUBIC_CASES,
                         ids=[f"{f[0]}x{f[1]}-{o[0]}x{o[1]}" for f, _, o in CUBIC_CASES])
def test_cubic_resize_matches_cv2_and_torch(frame, box, out):
    """The library's crop and bicubic resize against cv2.resize INTER_CUBIC
    and against the plain version (torch bicubic) on the frame the library
    decodes: within 1 level; against cv2 also at most 1e-3 of the values
    off (cv2 resizes 8-bit frames in float, as the library does)."""
    blob = _jpeg(*frame, seed=sum(frame))
    whole = tnative.decode_batch([blob], None, *frame)[0]
    boxes = None if box is None else np.asarray([box], np.int32)
    got = tnative.decode_batch([blob], boxes, *out, interp=2)[0].astype(np.int32)
    x1, y1, x2, y2 = (0, 0, frame[1], frame[0]) if box is None else box
    src = np.ascontiguousarray(whole[max(0, y1):min(frame[0], y2), max(0, x1):min(frame[1], x2)])
    by_cv2 = src if src.shape[:2] == out else cv2.resize(
        src, (out[1], out[0]), interpolation=cv2.INTER_CUBIC)
    by_torch = ttf.resize_plain(src[None], *out, interp=2)[0]
    for name, ref, mean_tol in (("cv2", by_cv2, 1e-3), ("torch", by_torch, 1e-2)):
        d = np.abs(got - ref.astype(np.int32))
        print(f"{name}: max {d.max()}, mean {d.mean():.3g}")
        assert d.max() <= 1 and d.mean() <= mean_tol, name


def test_jpeg_dims_read_the_headers():
    sizes = [(61, 77), (8, 8), (1, 300), (257, 13)]
    blobs = [_jpeg(h, w, i) for i, (h, w) in enumerate(sizes)]
    np.testing.assert_array_equal(tnative.jpeg_dims(blobs), np.asarray(sizes))
    for blob, (h, w) in zip(blobs, sizes):
        assert tnative.decode_batch([blob], None, h, w).shape == (1, h, w, 3)
        assert cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR).shape[:2] == (h, w)
    with pytest.raises(IOError):
        tnative.jpeg_dims([blobs[0], b"\xff\xd8\xff\xe0" + bytes(16)])
    assert tnative.jpeg_dims([]).shape == (0, 2)


# ----------------------------------------------------------- datasets


@pytest.mark.parametrize("split,label,fpv", [("train", "real", None), ("train", "fake", 2),
                                             ("test", "both", 2), ("dev", "both", None)])
def test_ocim_subdataset_matches_jax(fas, split, label, fpv):
    opts = _options(fas, **{f"{split}_dataset": "C" if split == "train" else "M",
                            f"{split}_fpv": fpv})
    got = tds.OCIMSubDataset(copy.deepcopy(opts), split, label)
    ref = jds.OCIMSubDataset(copy.deepcopy(opts), split, label)
    assert got.images == ref.images and got.targets == ref.targets
    assert got.categories == ref.categories == ["real", "attack"]
    assert len(got) == (3 * (fpv or 3)) * (2 if label == "both" else 1)


def test_ocim_dataset_matches_jax(fas):
    opts = _options(fas, train_fpv=2)
    got, ref = tds.get_dataset("OCIM")(opts, "train"), jds.OCIMDataset(opts, "train")
    assert got.num_domains == ref.num_domains == 2 and len(got.datasets) == 4
    for g, r, lab in zip(got.datasets, ref.datasets, (0, 1, 0, 1)):
        assert g.images == r.images and g.targets == r.targets == [lab] * 6
    for opts, split, label in ((_options(fas, train_dataset="X"), "train", "real"),
                               (_options(fas), "val", "real"),
                               (_options(fas, train_dataset="C"), "train", "spoof")):
        with pytest.raises(ValueError):
            tds.OCIMSubDataset(opts, split, label)


@pytest.mark.parametrize("split,label,margin", [("train", "real", (0.0, 0.5)),
                                                ("train", "fake", (0.0, 0.5)),
                                                ("test", "both", 0.3)])
def test_load_item_matches_jax(fas, split, label, margin):
    """Two batches (two margin draws) of 4p crops: training's
    RandomResizedCrop with the bicubic resize against the JAX stage's cv2
    path, validation's bilinear Resize; within 1 level."""
    opts = _options(fas, train_dataset="O", test_dataset="M")
    got_ds = tds.OCIMSubDataset(copy.deepcopy(opts), split, label)
    ref_ds = jds.OCIMSubDataset(copy.deepcopy(opts), split, label)
    n = len(got_ds)
    for sl in (slice(0, n // 2), slice(n // 2, n)):
        items, labels = got_ds.images[sl], got_ds.targets[sl]
        got = got_ds.load_item(items, labels, margin=margin, crop="4p")
        ref = ref_ds.load_item(items, labels, margin=margin, crop="4p")
        assert got["path"] == ref["path"]
        assert got["images"].shape == ref["images"].shape == (len(items), 32, 32, 3)
        d = np.abs(got["images"].astype(np.int32) - ref["images"])
        assert d.max() <= 1, d.max()
    assert got_ds.rng.random() == ref_ds.rng.random()
    assert got_ds.host_tf.rng.random() == ref_ds.host_tf.rng.random()


# ------------------------------------------------------------- engines


def _config(tmp, root, run_id, **data):
    ds_path = os.path.join(tmp, f"data-{run_id}.yml")
    with open(ds_path, "w") as f:
        yaml.safe_dump(_options(root, **data), f)
    return {
        "model": {"name": "UDR18", "num_classes": 2, "drop_rate": 0.5, "extractor": "resnet18",
                  "extractor_weights": "ckpt/resnet18.pth"},
        "config": {
            "local_rank": 0, "num_devices": 1, "lambda_triplet": 0.1, "lambda_recons": 0.1,
            "lambda_freq": 1.0, "lambda_mask": 0.1, "lambda_fac": 0.1,
            "optimizer": {"name": "adamw", "lr": 1e-4, "betas": [0.9, 0.999],
                          "weight_decay": 5e-5, "amsgrad": True},
            "crop": "4p", "warmup_step": 0, "resume": False, "id": run_id, "debug": False,
            "offline": True,
        },
        "data": {"train_batch_size": 2, "val_batch_size": 8, "test_batch_size": 12,
                 "num_workers": 1, "file": ds_path},
        "cfg_path": ds_path,
    }


@pytest.fixture(scope="module")
def engines(fas, tmp_path_factory):
    """The JAX OCIMEngine and the port's from one config (no JAX train step
    is compiled), in a working directory of their own."""
    from unidefense_tpu.engines import get_engine as jax_get_engine

    with module_tmp(tmp_path_factory, "ocim-engines") as path:
        tmp = str(path)
        cwd, stdout = os.getcwd(), sys.stdout
        os.chdir(tmp)
        try:
            ref = jax_get_engine("OCIM")(_config(tmp, fas, "jax-run"), stage="Train")
            got = get_engine("OCIM")(_config(tmp, fas, "port-run"), stage="Train", device="cpu")
        finally:
            sys.stdout = stdout
            os.chdir(cwd)
        yield got, ref


def test_load_batch_matches_jax(engines):
    """Steps 1-3 of the six domain streams' selections and loads (one
    worker): the same labels, real streams first in domain order, images
    within 1 level, in one buffer."""
    got, ref = engines
    assert len(got.batchers) == len(ref.batchers) == 4
    for step in (1, 2, 3):
        g_sel, r_sel = got._select_batch(step), ref._select_batch(step)
        # the port plans each load as it selects: its selection holds the plan
        assert [s[0]["path"] for s in g_sel] == [[i.split(" ")[0] for i in s[0]] for s in r_sel]
        g, r = got._load_batch(g_sel), ref._load_batch(r_sel)
        labels = g["label"].numpy()
        np.testing.assert_array_equal(labels, np.asarray(r["label"]))
        np.testing.assert_array_equal(labels, [0] * 4 + [1] * 4)
        d = np.abs(g["image"].numpy().astype(np.int32) - np.asarray(r["image"]))
        assert g["image"].shape == (8, 32, 32, 3) and d.max() <= 1, d.max()
        assert g["image"].untyped_storage().data_ptr() == g["label"].untyped_storage().data_ptr()


def test_score_dataset_matches_jax(engines, jax_native):
    """The validation split (M, margin 0.3) scored by the port and by the
    JAX engine (its validation flips off) from the same weights, both
    decoding through the same libjpeg code: per-video probabilities within
    1e-5, the EER-threshold metrics within 1e-9."""
    from unidefense_tpu.utils.metrics import cal_metrics as jax_cal_metrics

    got, ref = engines
    v = {"params": jax.tree.map(np.asarray, ref.state.params),
         "batch_stats": jax.tree.map(np.asarray, ref.state.batch_stats)}
    v = _scaled(_randomise(v, classifier_std=0.05))
    load = {"margin": 0.3, "crop": "4p"}
    got.state.model.load_state_dict(state_dict_from_jax(v), strict=True)
    _spread_bottleneck(got, v, load)
    got.state.model.load_state_dict(state_dict_from_jax(v), strict=True)
    ref.state = ref.state.replace(params=v["params"], batch_stats=v["batch_stats"])
    # the JAX engine's eval step preprocesses with the training stage, which
    # flips at random; the port's validates as test_transforms say
    ref.train_set.datasets[0].device_tf.hflip_p = 0.0
    g = got.gather_eval_output(*got.score_dataset(got.val_set, 8, load, 0))
    r = ref.gather_eval_output(*ref.score_dataset(ref.val_set, 8, load, 0))
    assert g["video_tgt"] == r["video_tgt"] and len(g["video_tgt"]) == 6
    np.testing.assert_allclose(g["video_prob"], r["video_prob"], rtol=0, atol=1e-5)
    assert np.ptp(r["video_prob"]) > 1e-3  # the videos' probabilities do differ
    m_got = cal_metrics(np.asarray(g["video_tgt"]), np.asarray(g["video_prob"]), threshold="auto")
    m_ref = jax_cal_metrics(np.asarray(r["video_tgt"]), np.asarray(r["video_prob"]),
                            threshold="auto")
    for k in ("EER", "ACER", "AUC", "ACC", "APCER", "BPCER", "NumP", "NumN"):
        assert m_got[k] == pytest.approx(m_ref[k], abs=1e-9), k
    # the threshold is a probability: held as the probabilities are
    assert m_got["Thre"] == pytest.approx(m_ref["Thre"], abs=1e-5)


def test_ocim_engine_lifecycle(fas, tmp_path, monkeypatch, capsys):
    """`--engine OCIM` through main on the CPU: 2 steps validated at each,
    the best checkpoint by AUC - HTER, `--test` from it; then a resume whose
    six streams select at steps 3 and 4 what an uninterrupted run selects."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmain, "get_engine",
                        lambda name: functools.partial(get_engine(name), device="cpu"))
    cfg = _config(str(tmp_path), fas, "life", test_fpv=2)
    model_yml = tmp_path / "model.yml"
    with open(model_yml, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.items() if k != "cfg_path"}, f)
    argv = ["--config", str(model_yml), "--engine", "OCIM", "--offline"]
    engine = tmain.main(argv)
    out = capsys.readouterr().out
    assert engine.state.step == 2 and engine.device.type == "cpu"
    evals = [ln for ln in out.splitlines() if ln.startswith("Eval Step")]
    assert len(evals) == 2 and "Train Iter (2/2)" in out and "HTER" in evals[0]
    scores = [float(ln.split("AUC ")[1].split(",")[0]) - float(ln.split("HTER ")[1].split(",")[0])
              for ln in evals]
    assert engine.best_step == (2 if scores[1] > scores[0] else 1)
    assert engine.ckpt.exists(best=True) and engine.ckpt.exists(best=False)
    tested = tmain.main(argv + ["--test"])
    out = capsys.readouterr().out
    assert f"Loaded best checkpoint: step {engine.best_step}" in out
    assert "Test | EER" in out and "APCER" in out and "#Neg" in out
    assert len(tested.test_set) == 3 * 2 * 2

    resumed = get_engine("OCIM")(_config(str(tmp_path), fas, "life", num_steps=4) | {
        "config": dict(cfg["config"], resume=True)}, device="cpu")
    straight = get_engine("OCIM")(_config(str(tmp_path), fas, "straight", num_steps=4),
                                  device="cpu")
    assert resumed.start_step == 3 and resumed.state.step == 2
    resumed._make_prefetcher()  # fast-forwards every stream to step 3
    want = [straight._select_batch(s) for s in (1, 2, 3, 4)][2:]
    for step, sels in zip((3, 4), want):
        assert [s[0]["path"] for s in resumed._select_batch(step)] == \
            [s[0]["path"] for s in sels], step


@pytest.mark.parametrize("entry", ["engine", "main"])
def test_ocim_defaults_to_cuda_and_raises_without_a_card(fas, tmp_path, monkeypatch, entry):
    """The OCIM engine's constructor (device=None) and `--engine OCIM`
    refuse to run without a card, before they read a dataset or write a
    run directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg = _config(str(tmp_path), fas, "no-card")
    model_yml = tmp_path / "model.yml"
    with open(model_yml, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.items() if k != "cfg_path"}, f)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "engine":
            get_engine("OCIM")(cfg, stage="Train")
        else:
            tmain.main(["--config", str(model_yml), "--engine", "OCIM", "--offline"])
    assert not (tmp_path / "runs").exists()
