"""The rest of serving in the port against the JAX package, on the CPU in
fp32: int8 weights (unidefense_torch/ops/quant.py) and the ``Predictor``'s
``quantize``, ``param_bytes``, ``from_run`` and ``from_torch_checkpoint``;
the export of a run (unidefense_torch/tools/export_checkpoint.py); Celeb-DF
and WildDeepfake, the cross-dataset ``--test`` targets; and the repaired
race of ``score_dataset``'s two decode threads over the distorted test's
draws. UDR18 at 32x32; weights drawn in numpy from a seed
(``test_torch_weights._variables``)."""

import copy
import os
import threading
import time
from concurrent import futures

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_data import jax_native, udjpeg  # noqa: F401 (fixtures)
from tests.test_torch_engine import _engine, _keep_stdout, _one_thread, fe_config, ffpp  # noqa: F401
from tests.test_torch_uniattack import _config as _ue_config
from tests.test_torch_uniattack import ua  # noqa: F401 (fixture)
from tests.test_torch_weights import _variables
from unidefense_torch.checkpoint import CheckpointManager
from unidefense_torch.data import datasets as tds
from unidefense_torch.data.transforms import LockedRNG
from unidefense_torch.engines import get_engine
from unidefense_torch.inference import Predictor
from unidefense_torch.models.convert import _layout, state_dict_from_jax, torch_key
from unidefense_torch.models.registry import build_model
from unidefense_torch.ops import quant as tquant
from unidefense_torch.tools import export_checkpoint
from unidefense_torch.train.optim import build_optimizer
from unidefense_torch.train.step import create_train_state
from unidefense_tpu.data import datasets as jds
from unidefense_tpu.inference import Predictor as JaxPredictor
from unidefense_tpu.models import convert as jconv
from unidefense_tpu.models.unidefense import UniDefenseModelRes18
from unidefense_tpu.ops.quant import QArray, quantize_tree

SIZE = 32
ZERO_RATES = {"drop_rate": 0.0, "feat_drop_rate": 0.0}
TOL = dict(rtol=1e-3, atol=1e-3)  # the Predictor tests of test_torch_resnet / test_torch_models


@pytest.fixture(scope="module")
def udr18():
    """UDR18's JAX module and seeded variables, a classifier wide enough
    that the probabilities differ per frame, and eight frames."""
    jm = UniDefenseModelRes18(dtype=jnp.float32, **ZERO_RATES)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    v = _variables(shapes, 4)
    v["params"]["classifier"]["Dense_0"]["kernel"] *= 10.0
    frames = np.random.default_rng(6).integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
    return jm, v, frames


def _port(v, **kw):
    return Predictor("UDR18", dict(ZERO_RATES), state_dict=state_dict_from_jax(v),
                     input_size=SIZE, batch_size=4, dtype=torch.float32, device="cpu", **kw)


def _jax(v, **kw):
    return JaxPredictor("UDR18", dict(ZERO_RATES), variables=v, input_size=SIZE, batch_size=4,
                        dtype=jnp.float32, **kw)


# ------------------------------------------------------------------ int8


def test_int8_weights_equal_jax_leaf_for_leaf(udr18):
    """The port's q and scale of every >= 2-D parameter equal the JAX
    package's ``quantize_tree`` after the layout map (the decoder's
    ConvTranspose, whose output channels are axis 1, among them): 0
    differing elements. 1-D and 0-D parameters are not quantized."""
    _, v, _ = udr18
    ref = quantize_tree(v["params"])
    model = build_model("UDR18", ZERO_RATES)
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    got = tquant.Int8Weights(model)
    flat = {}

    def visit(tree, path=()):
        for k, val in tree.items():
            if isinstance(val, dict):
                visit(val, path + (k,))
            else:
                flat[path + (k,)] = val

    visit(ref)
    quantized = {p: val for p, val in flat.items() if isinstance(val, QArray)}
    assert {torch_key(p) for p in quantized} == set(got.weights)
    axes = {}
    for path, qa in quantized.items():
        key = torch_key(path)
        _, q, scale, axis = got.weights[key]
        ref_q = torch.from_numpy(_layout(path, np.asarray(qa.q)).astype(np.int8))
        assert q.dtype == torch.int8 and q.shape == ref_q.shape, key
        assert int((q != ref_q).sum()) == 0, key
        assert torch.equal(scale, torch.from_numpy(np.array(qa.scale))), key
        axes[key] = axis
    deconvs = [k for k in axes if k.startswith("dec_block") and k.endswith(".3.weight")]
    assert deconvs and all(axes[k] == 1 for k in deconvs)
    assert all(axes[k] == 0 for k in axes if k not in deconvs)


def test_param_bytes_equal_jax(udr18):
    """``param_bytes`` equals the JAX Predictor's, fp32 and int8: the
    parameters only (no BatchNorm statistics or counters, no frozen
    bottleneck bias), int8 values and fp32 scales as stored."""
    _, v, _ = udr18
    for quantize in (None, "int8"):
        assert _port(v, quantize=quantize).param_bytes() == \
            _jax(v, quantize=quantize).param_bytes(), quantize
    assert _port(v, quantize="int8").param_bytes() < 0.3 * _port(v).param_bytes()


def test_int8_predictor_matches_jax(udr18):
    """The int8 Predictor's probabilities against the JAX int8 Predictor's
    on the same weights and frames (both dequantize the same q and scale in
    fp32), within the Predictor tests' 1e-3; within test_quant's 0.05 of
    the port's own fp32 Predictor."""
    _, v, frames = udr18
    got = _port(v, quantize="int8").predict_frames(frames[:6])
    ref = _jax(v, quantize="int8").predict_frames(frames[:6])
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.ptp(ref) > 1e-2  # the probabilities do differ per frame
    np.testing.assert_allclose(got, _port(v).predict_frames(frames[:6]), atol=0.05)


def test_dequantize_runs_in_the_compute_dtype():
    """``q.to(dtype) * scale.to(dtype)``: in bf16 the product is rounded
    once in bf16, as the JAX package's ``dequantize`` does."""
    q = torch.tensor([[127, -3], [45, 101]], dtype=torch.int8)
    scale = torch.tensor([0.0123457, 0.987654])
    got = tquant.dequantize_weight(q, scale, 0, torch.bfloat16)
    want = q.to(torch.bfloat16) * scale.to(torch.bfloat16)[:, None]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    jq = QArray(jnp.asarray(q.numpy()).T, jnp.asarray(scale.numpy()))
    ref = np.asarray(jq.dequantize(jnp.bfloat16).astype(jnp.float32)).T
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_predictor_refuses_unknown_modes_and_devices(udr18):
    """An unknown ``quantize`` raises ValueError, in the constructor and on
    a reinstall (the alternate constructors set it after __init__, as
    tests/test_quant.py checks of the JAX Predictor); devices that do not
    divide the batch raise ValueError, as in the JAX Predictor."""
    _, v, _ = udr18
    with pytest.raises(ValueError, match="fp4"):
        _port(v, quantize="fp4")
    pred = _port(v)
    pred.quantize = "int4"
    with pytest.raises(ValueError, match="int4"):
        pred._install()
    with pytest.raises(ValueError, match="batch_size 4 not divisible by num_devices 3"):
        _port(v, num_devices=3)


def test_from_run_export_and_from_torch_checkpoint(udr18, tmp_path):
    """A port run's ``ckpt/best``: ``from_run`` serves its weights (no
    optimizer state read); the export tool writes the reference's format,
    which ``from_torch_checkpoint`` serves with bit-equal probabilities and
    the JAX loader reads back to the same weights; int8 from the file
    equals int8 from the state_dict."""
    _, v, frames = udr18
    model = build_model("UDR18", ZERO_RATES)
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    tx, _ = build_optimizer({"optimizer": {"name": "adamw", "lr": 1e-4, "amsgrad": True}})
    state = create_train_state(model, tx, "cpu")
    state.step = 5
    run = str(tmp_path / "run")
    CheckpointManager(run).save(state, {"step": 5, "best_auc": 0.75}, best=True)
    kw = dict(input_size=SIZE, batch_size=4, dtype=torch.float32, device="cpu")

    served = Predictor.from_run(run, "UDR18", dict(ZERO_RATES), **kw)
    for k, t in model.state_dict().items():
        assert torch.equal(served.model.state_dict()[k], t), k
    probs = served.predict_frames(frames)
    np.testing.assert_array_equal(probs, _port(v).predict_frames(frames))

    out = str(tmp_path / "export.bin")
    export_checkpoint.main(["--run", run, "--out", out, "--best"])
    payload = torch.load(out, weights_only=False)
    assert payload["step"] == 5 and payload["best_auc"] == 0.75
    with pytest.raises(FileNotFoundError):
        export_checkpoint.export_run(run, str(tmp_path / "none.bin"), best=False)
    loaded = Predictor.from_torch_checkpoint(out, "UDR18", dict(ZERO_RATES), seed=3, **kw)
    np.testing.assert_array_equal(loaded.predict_frames(frames), probs)
    back = jconv.load_unidefense_checkpoint(copy.deepcopy(v), out)
    for k, t in state_dict_from_jax(back).items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, model.state_dict()[k]), k
    q_file = Predictor.from_torch_checkpoint(out, "UDR18", dict(ZERO_RATES), quantize="int8", **kw)
    assert q_file.quantize == "int8"
    np.testing.assert_array_equal(q_file.predict_frames(frames),
                                  _port(v, quantize="int8").predict_frames(frames))


# ----------------------------------------------------- Celeb-DF, WildDeepfake

CDF_VIDEOS = {"YouTube-real": ["00000", "00001", "00002"], "Celeb-real": ["id0_0000", "id1_0000"],
              "Celeb-synthesis": ["id0_id1_0000", "id1_id2_0000", "id2_id0_0001"]}
TRANSFORMS = [{"name": "Resize", "params": {"height": SIZE, "width": SIZE}},
              {"name": "Normalize", "params": {"mean": [0.5] * 3, "std": [0.5] * 3}}]


def write_cdf(root, frames=4, size=(40, 44)):
    """A Celeb-DF v2 tree: PNG frames, each the decode of a seeded noise
    JPEG (kept by path in the returned dict, the PNG's JPEG twin), and
    List_of_testing_videos.txt naming one video of each method."""
    twins = {}
    for m, videos in CDF_VIDEOS.items():
        for v, vid in enumerate(videos):
            for f in range(frames):
                path = os.path.join(root, m, "images", vid, f"{f:04d}.png")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                img = np.random.default_rng([len(m), v, f]).integers(0, 256, (*size, 3),
                                                                      dtype=np.uint8)
                twins[path] = cv2.imencode(".jpg", img)[1].tobytes()
                cv2.imwrite(path, cv2.imdecode(np.frombuffer(twins[path], np.uint8),
                                               cv2.IMREAD_COLOR))
    with open(os.path.join(root, "List_of_testing_videos.txt"), "w") as f:
        f.write("1 YouTube-real/00001.mp4\n1 Celeb-real/id1_0000.mp4\n"
                "0 Celeb-synthesis/id2_id0_0001.mp4\n")
    return twins


def write_wdf(root, frames=3):
    """A WildDeepfake tree: ``<split>/<method>.pickle`` of split-relative
    JPEG frame paths, 4 real and 4 fake videos per split."""
    for split in ("train", "test"):
        for m in ("real", "fake"):
            items = []
            for v in range(4):
                for f in range(frames):
                    rel = f"{m}_videos/{v:03d}/{f:04d}.jpg"
                    os.makedirs(os.path.join(root, split, os.path.dirname(rel)), exist_ok=True)
                    img = np.random.default_rng([len(split), len(m), v, f]).integers(
                        0, 256, (36, 30, 3), dtype=np.uint8)
                    cv2.imwrite(os.path.join(root, split, rel), img)
                    items.append(rel)
            torch.save(items, os.path.join(root, split, f"{m}.pickle"))


@pytest.fixture(scope="module")
def cdf(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cdf"))
    return root, write_cdf(root)


@pytest.fixture(scope="module")
def wdf(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wdf"))
    write_wdf(root)
    return root


def _opts(root, **kw):
    return dict({"root": root, "use_lmdb": False, "train_transforms": TRANSFORMS,
                 "test_transforms": TRANSFORMS}, **kw)


@pytest.mark.parametrize("split", ["train", "test"])
def test_cdf_index_matches_jax(cdf, split):
    """The same (frame, label) pairs as the JAX CelebDF, the port's in
    sorted order (videos, then frames); the test videos are those listed,
    training the complement; label 0 iff "real" is in the path."""
    root, _ = cdf
    opts = _opts(root, method=list(CDF_VIDEOS))
    got, ref = tds.get_dataset("CDF")(dict(opts), split), jds.CelebDF(dict(opts), split)
    assert sorted(zip(got.images, got.targets)) == sorted(zip(ref.images, ref.targets))
    assert got.images == sorted(got.images, key=lambda p: (
        list(CDF_VIDEOS).index(p.split(os.sep)[-4]), p))
    assert got.targets == [0 if "real" in p else 1 for p in got.images]
    videos = {p.rsplit("/", 1)[0].split("/")[-1] for p in got.images}
    listed = {"00001", "id1_0000", "id2_id0_0001"}
    assert videos == (listed if split == "test" else {v for vs in CDF_VIDEOS.values()
                                                      for v in vs} - listed)
    assert got.categories == ["original", "fake"]
    with pytest.raises(ValueError):
        tds.CelebDF(dict(opts), "val")


def test_cdf_fpv_caps_each_video_repeatably(cdf):
    """``train_fpv``: each video keeps min(fpv, its frames), a subset of its
    own frames, the same count per video as the JAX class, and the same
    pick from the same seed."""
    root, _ = cdf
    opts = _opts(root, method=list(CDF_VIDEOS), train_fpv=2)
    full = tds.CelebDF(_opts(root, method=list(CDF_VIDEOS)), "train")
    a, b = tds.CelebDF(dict(opts), "train"), tds.CelebDF(dict(opts), "train")
    ref = jds.CelebDF(dict(opts), "train")
    assert a.images == b.images and a.targets == b.targets
    assert set(a.images) <= set(full.images)

    def per_video(images):
        out = {}
        for p in images:
            out.setdefault(p.rsplit("/", 1)[0], []).append(p)
        return out

    got, want = per_video(a.images), per_video(ref.images)
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    assert all(len(v) == 2 for v in got.values())
    assert tds.CelebDF(dict(opts), "train", seed=7).images != a.images


def test_wdf_index_matches_jax(wdf):
    """The same index as the JAX WildDeepfake, its items root-joined under
    the split; ``train_fpv`` caps each video."""
    opts = _opts(wdf, method=["real", "fake"])
    for split in ("train", "test"):
        got, ref = tds.get_dataset("WDF")(dict(opts), split), jds.WildDeepfake(dict(opts), split)
        assert got.images == ref.images and got.targets == ref.targets
        assert [got[i] for i in range(len(got))] == [ref[i] for i in range(len(ref))]
        assert got[0][0] == os.path.join(wdf, split, got.images[0])
        assert sum(got.targets) == 12 and len(got) == 24
    capped = tds.WildDeepfake(_opts(wdf, method=["fake"], train_fpv=1), "train")
    assert len(capped) == 4 and capped.images == tds.WildDeepfake(
        _opts(wdf, method=["fake"], train_fpv=1), "train").images
    out = capped.load_item([capped[i][0] for i in range(4)], None, crop="nocrop")
    assert out["images"].shape == (4, SIZE, SIZE, 3)


def test_cdf_load_item_matches_jax(cdf, jax_native, monkeypatch):
    """A batch of Celeb-DF PNG frames: bit for bit the JAX package's native
    decode of each PNG's JPEG twin, and within 1 level of the JAX
    package's own route for a batch holding a PNG (cv2)."""
    root, twins = cdf
    opts = _opts(root, method=list(CDF_VIDEOS))
    got_ds, ref_ds = tds.CelebDF(dict(opts), "train"), jds.CelebDF(dict(opts), "train")
    twin_ds = jds.CelebDF(dict(opts), "train")
    monkeypatch.setattr(twin_ds, "_read_blob", lambda path: twins[path])
    items = got_ds.images[:10]
    got = got_ds.load_item(items, None, crop="nocrop")
    twin = twin_ds.load_item(items, None, crop="nocrop")
    ref = ref_ds.load_item(items, None, crop="nocrop")
    assert got["path"] == ref["path"] == items
    assert got["images"].shape == (10, SIZE, SIZE, 3)
    np.testing.assert_array_equal(got["images"], twin["images"])
    assert np.abs(got["images"].astype(np.int32) - ref["images"]).max() <= 1


def _data_yml(path, root, name, real, fake):
    with open(path, "w") as f:
        yaml.safe_dump({"root": root, "name": name, "use_lmdb": False, "real_method": real,
                        "fake_method": fake, "num_steps": 2, "log_steps": 1, "val_steps": 1,
                        "train_transforms": TRANSFORMS, "test_transforms": TRANSFORMS}, f)
    return str(path)


def test_fe_test_on_cdf_matches_jax_engine(fe_config, cdf, udr18, jax_native, monkeypatch,
                                           tmp_path, capsys):
    """``--test`` of an FF++-trained FE run on Celeb-DF: the port's Test-stage
    engine restores the run's best checkpoint and scores the CDF test split;
    its per-video probabilities, keyed by video, equal the JAX
    ForgeryEngine's from the same weights within 1e-5 (the JAX engine, built
    in its Train stage, falls back to CDF's test split for validation; it
    reads each PNG's JPEG twin, and its flip is off). No JAX train step is
    compiled."""
    from unidefense_tpu.engines import base as jax_engine_base
    from unidefense_tpu.engines import get_engine as jax_get_engine
    from unidefense_tpu.train.step import TrainState

    root, twins = cdf
    _, v, _ = udr18
    # a run to test: the FF++ config's run directory, holding a best checkpoint
    trained = _engine(fe_config, id="cdf-run")
    trained.state.model.load_state_dict(state_dict_from_jax(v), strict=True)
    trained.ckpt.save(trained.state, trained._meta(1) | {"best_step": 1}, best=True)

    cfg = copy.deepcopy(fe_config)
    cfg["data"]["file"] = _data_yml(tmp_path / "data_cdf.yml", root, "CDF",
                                    ["YouTube-real", "Celeb-real"], ["Celeb-synthesis"])
    cfg["data"]["test_batch_size"] = 4
    cfg["config"]["id"] = "cdf-run"
    port = get_engine("FE")(copy.deepcopy(cfg), stage="Test", device="cpu")
    metrics = port.test()
    assert "Loaded best checkpoint: step 1" in capsys.readouterr().out
    assert 0.0 <= metrics["AUC"] <= 1.0 and metrics["NumP"] + metrics["NumN"] == 12
    got, _ = port.score_dataset(port.test_set, 4, {"crop": "nocrop"}, -1, desc="test")

    jax_cfg = copy.deepcopy(cfg)
    jax_cfg["config"]["id"] = "cdf-jax"
    # the JAX engine starts from the weights, not from a jitted init (whose
    # compile takes 10 s here); it builds no train step
    monkeypatch.setattr(jax_engine_base, "create_train_state", lambda *a: TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=None))
    ref_engine = jax_get_engine("FE")(jax_cfg, stage="Train")
    ref_engine.train_real_set.device_tf.hflip_p = 0.0
    val = ref_engine.val_set
    monkeypatch.setattr(val, "_read_blob", lambda path: twins[path])
    # the JAX index in sorted order: each video's frames in the port's order
    val.images, val.targets = (list(x) for x in zip(*sorted(zip(val.images, val.targets))))
    ref, _ = ref_engine.score_dataset(ref_engine.val_set, 4, {"crop": "nocrop"}, -1)
    assert set(got) == set(ref) and len(got) == 3
    for video, probs in ref.items():
        np.testing.assert_allclose(got[video], probs, rtol=0, atol=1e-5, err_msg=video)
    assert np.ptp([p for ps in ref.values() for p in ps]) > 1e-2


# ----------------------------------------------- the distorted test's draws


def test_distorted_test_draws_in_batch_order(ua, tmp_path, monkeypatch):
    """The Protocol I distorted test split scored three times by
    ``score_dataset`` from the same seeds: twice on two decode threads,
    the first draw held back 0.3 s (where the draws run on the threads,
    batch 1's then draw first), and once on one thread. Every draw is made
    on the calling thread in batch order, so all three runs score the same
    frames with the same probabilities."""
    monkeypatch.chdir(tmp_path)
    engine = get_engine("UE")(_ue_config(str(tmp_path), ua, "race", distorted=True),
                              stage="Train", device="cpu")
    dataset, host = engine.test_set, engine.test_set.host_tf
    assert host.distorted_oneof
    draw, eval_step, pool = host.draw, engine.eval_step, futures.ThreadPoolExecutor
    runs = []
    for workers in (2, 2, 1):
        dataset.rng, host.rng = LockedRNG(2022), LockedRNG(5)
        first, frames = threading.Event(), []

        def held(*args, first=first):
            if not first.is_set():  # batch 0's first draw: let batch 1's go ahead
                first.set()
                time.sleep(0.3)
            return draw(*args)

        host.draw = held
        engine.eval_step = lambda x, g=None, frames=frames: frames.append(x.clone()) or \
            eval_step(x, g)
        monkeypatch.setattr(futures, "ThreadPoolExecutor",
                            lambda max_workers, workers=workers: pool(max_workers=workers))
        probs, _ = engine.score_dataset(dataset, 4, {"crop": "nocrop"}, 0, desc="test")
        runs.append((frames, probs))
    (f0, p0), *rest = runs
    assert len(f0) > 2
    for frames, probs in rest:
        assert len(frames) == len(f0) and all(torch.equal(a, b) for a, b in zip(frames, f0))
        assert probs == p0
