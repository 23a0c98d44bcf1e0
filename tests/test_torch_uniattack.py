"""The port's UniAttack path (unidefense_torch) against the JAX package's on
the CPU, on a synthetic six-source tree (one FrameStore per sub-dataset,
frames of six sizes, the index files in each loader's layout): the index
loaders, the loaded items (mixed sources, nocrop and 4p, fixed and drawn
margins, domain labels, Resize and RandomResizedCrop), the host stage
(the Protocol I distorted OneOf, ImageCompression, their draws in the JAX
stage's order beside RandomResizedCrop's), the device corruption route and
its blur, the transform list, and the UE engine: validation threshold and
test metrics against the JAX UniAttackEngine's, the lifecycle through the
CLI with its resume, and the card by default."""

import copy
import functools
import os
import pickle
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_data import jax_native, udjpeg  # noqa: F401 (fixtures)
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
from unidefense_torch.ops.perturb import gaussian_blur
from unidefense_torch.utils.metrics import cal_metrics
from unidefense_tpu.data import datasets as jds
from unidefense_tpu.data import transforms as jtf

# (H, W) of each sub-dataset's frames: six sizes, so that a batch mixes them
SIZES = {"FFpp": (40, 44), "CDF": (36, 40), "SeqDF": (50, 40), "HQ": (48, 56),
         "OULU": (60, 44), "SiWMv2": (42, 52)}
STORES = dict(tds.UniAttack.SUBSETS)
RESIZE = [{"name": "Resize", "params": {"height": 32, "width": 32}},
          {"name": "Normalize", "params": {"mean": [0.5] * 3, "std": [0.5] * 3}}]
RRC = {"name": "RandomResizedCrop",
       "params": {"height": 32, "width": 32, "interpolation": 2, "p": 1.0, "scale": [0.8, 1.0]}}
TRAIN_TF = [RRC, {"name": "HorizontalFlip", "params": {"p": 0.5}}, RESIZE[1]]
FFPP = {"Real": "original_sequences/youtube/c23/images/{v:03d}/{f:04d}.jpg",
        "DF": "manipulated_sequences/Deepfakes/c23/images/{v:03d}_x/{f:04d}.jpg",
        "F2F": "manipulated_sequences/Face2Face/c23/images/{v:03d}_x/{f:04d}.jpg",
        "FS": "manipulated_sequences/FaceSwap/c23/images/{v:03d}_x/{f:04d}.jpg",
        "NT": "manipulated_sequences/NeuralTextures/c23/images/{v:03d}_x/{f:04d}.jpg"}
# Celeb-DF's frames are PNG, as the reference lays the dataset out
CDF = {"Celeb-real/images/id0_{v:04d}/{f}.png": 0, "YouTube-real/images/{v:05d}/{f}.png": 0,
       "Celeb-synthesis/images/id0_id1_{v:04d}/{f}.png": 1}
# the JPEG whose decode each Celeb-DF PNG holds, by path (write_uniattack)
CDF_JPEG = {}
HQ_ATTACKS = ("Glasses", "Tattoo", "Replay")


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


def write_uniattack(root, videos=2, frames=3):
    """Six sub-datasets under ``root``, each a FrameStore
    ``<root>/<subset>/lmdb/<store>.udb`` of q95 JPEG frames (cv2.imencode)
    of smoothed seeded noise at its own size, Celeb-DF's PNG (cv2.imencode
    of a JPEG's decode, the JPEG kept in ``CDF_JPEG``), and its index
    files: FF++
    ``pickle_files/<split>_c23.pickle`` of (path, label), Celeb-DF
    ``pickle_files/<split>.pickle`` of paths, Seq-DeepFake
    ``pickle_files/<split>_<real|fake>.pickle``, HQ-WMCA ``record.pickle`` and
    its protocol CSV (train/dev/eval), Oulu-NPU ``lists/<real|fake>_5points
    .pickle`` over its Train/Dev/Test_files, SiW-Mv2 ``lists/<split>list_
    <live|all>.pickle``. The four spoofing sources' items carry a face box
    (every third within 3 px of an edge) and are stored under the path and
    under the ``_crop`` key; FF++ and Celeb-DF under the path alone.
    Returns the subset roots as the data YAML names them."""
    rng = np.random.default_rng(11)
    roots = {k: os.path.join(root, k) for k in SIZES}
    splits = ("train", "val", "test")

    def frame(sub):
        h, w = SIZES[sub]
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (3, 3), 0)
        return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()

    def face(sub, i):
        h, w = SIZES[sub]
        bw, bh = 22, 26
        if i % 3 == 0:
            x, y = int(rng.integers(0, 3)), int(rng.integers(h - bh - 2, h - bh + 1))
        else:
            x, y = int(rng.integers(4, w - bw - 4)), int(rng.integers(4, h - bh - 4))
        return f" 0 {x} {y} {bw} {bh}"

    def dump(obj, *parts):
        os.makedirs(os.path.dirname(os.path.join(*parts)), exist_ok=True)
        torch.save(obj, os.path.join(*parts))

    writers = {}
    for sub, store in STORES.items():
        os.makedirs(os.path.join(roots[sub], "lmdb"))
        writers[sub] = FrameStoreWriter(os.path.join(roots[sub], "lmdb", f"{store}.udb"))

    def spoof_items(sub, pattern, crop_key, n_videos=videos):
        items = []
        for v in range(n_videos):
            for f in range(frames):
                rel = pattern.format(v=v, f=f)
                blob = frame(sub)
                writers[sub].add(rel, blob)
                writers[sub].add(crop_key(rel), blob)
                items.append(rel + face(sub, v * frames + f))
        return items

    ffpp = []
    for method, pattern in FFPP.items():
        for v in range(videos):
            for f in range(frames):
                rel = pattern.format(v=v, f=f)
                writers["FFpp"].add(rel, frame("FFpp"))
                ffpp.append((rel, 0 if method == "Real" else 1))
    cdf = []
    for pattern in CDF:
        for v in range(videos):
            for f in range(frames):
                rel = pattern.format(v=v, f=f)
                CDF_JPEG[rel] = frame("CDF")
                pixels = cv2.imdecode(np.frombuffer(CDF_JPEG[rel], np.uint8), cv2.IMREAD_COLOR)
                writers["CDF"].add(rel, cv2.imencode(".png", pixels)[1].tobytes())
                cdf.append(rel)
    for split in splits:
        dump(ffpp, roots["FFpp"], "pickle_files", f"{split}_c23.pickle")
        dump(cdf, roots["CDF"], "pickle_files", f"{split}.pickle")

    def suffixed(rel):
        return rel[:-4] + "_crop.jpg"

    for split in splits:
        for label in ("real", "fake"):
            dump(spoof_items("SeqDF", f"Seq-DeepFake/{split}/{label}/v{{v}}/{{f}}.jpg", suffixed),
                 roots["SeqDF"], "pickle_files", f"{split}_{label}.pickle")
        for label, kind in (("live", "live"), ("all", "spoof")):
            dump(spoof_items("SiWMv2", f"SiW-Mv2/{split}/{kind}_v{{v}}/{{f}}.jpg", suffixed),
                 roots["SiWMv2"], "lists", f"{split}list_{label}.pickle")
    oulu = {"real": [], "fake": []}
    for files in ("Train_files", "Dev_files", "Test_files"):
        for label in oulu:
            oulu[label] += spoof_items("OULU", f"Oulu_NPU/{files}/{label}_v{{v}}/f{{f}}.jpg",
                                       lambda rel: rel.replace("Oulu_NPU", "Oulu_NPU_crop"))
    for label, items in oulu.items():
        dump(items, roots["OULU"], "lists", f"{label}_5points.pickle")
    record, rows = {}, []
    for split in ("train", "dev", "eval"):
        for kind in ("bonafide",) + HQ_ATTACKS:
            for v in range(videos):
                name = f"{split}_{kind}_{v}"
                record[name] = spoof_items(
                    "HQ", f"HQ_WMCA/{name}/f{{f}}.jpg",
                    lambda rel: rel.replace(".jpg", "_crop.jpg"), n_videos=1)
                label = "0,bonafide" if kind == "bonafide" else f"1,attack/{kind}"
                rows.append(f"sess/{name},{label},x,{split}")
    dump(record, roots["HQ"], "record.pickle")
    with open(os.path.join(roots["HQ"], "PROTOCOL-grand_test-curated.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    for w in writers.values():
        w.close()
    return {f"{k}_root": v for k, v in roots.items()}


@pytest.fixture(scope="module")
def ua(tmp_path_factory):
    return write_uniattack(str(tmp_path_factory.mktemp("uniattack")))


def _options(roots, **kw):
    opts = {"root": "/", "name": "UniAttack", **roots, "train_transforms": TRAIN_TF,
            "val_transforms": RESIZE, "test_transforms": RESIZE}
    opts.update(kw)
    return opts


def _pair(opts, split, methods):
    return (tds.UniAttack(copy.deepcopy(opts), split, methods),
            jds.UniAttack(copy.deepcopy(opts), split, methods))


ALL_REAL = [m for m in tds.UniAttack.METHOD if m.endswith("-Real")]
ALL_FAKE = [m for m in tds.UniAttack.METHOD if not m.endswith("-Real")]
# (split, methods, real fpv, fake fpv)
INDEX_CASES = [
    ("train", ["FFpp-Real", "FFpp-DF", "FFpp-NT"], 2, 1),
    ("val", ["CDF-Real", "CDF-Fake"], 2, None),
    ("test", ["SeqDF-Real", "SeqDF-Fake"], 1, 1),
    ("train", ["HQ-Real", "HQ-Glasses", "HQ-Tattoo", "HQ-Makeup"], None, None),
    ("val", ["HQ-Real", "HQ-Replay"], None, 1),
    ("val", ["OULU-Real", "OULU-Fake"], 2, 2),
    ("test", ["SiWMv2-Real", "SiWMv2-Fake"], 2, 1),
    ("train", ALL_REAL + ALL_FAKE, 2, 1),
]


@pytest.mark.parametrize("split,methods,real_fpv,fake_fpv", INDEX_CASES,
                         ids=["ffpp", "cdf", "seqdf", "hq-train", "hq-dev", "oulu", "siwmv2",
                              "mixed"])
def test_index_loaders_match_jax(ua, split, methods, real_fpv, fake_fpv):
    """Each loader's images and targets equal the JAX package's, fpv
    resampling included (Seq-DeepFake is never resampled)."""
    opts = _options(ua, **{f"{split}_real_fpv": real_fpv, f"{split}_fake_fpv": fake_fpv})
    got, ref = _pair(opts, split, methods)
    assert [str(p) for p in got.images] == [str(p) for p in ref.images]
    assert got.targets == ref.targets and len(got) > 0
    assert got.categories == ref.categories == ["original", "fake"]
    assert set(got.targets) == {0, 1} or len(methods) == 1


def test_uniattack_refuses_what_jax_refuses(ua):
    for split, methods in (("dev", ["FFpp-Real"]), ("train", ["FFpp-Origin"])):
        with pytest.raises(ValueError):
            tds.UniAttack(_options(ua), split, methods)
    ds = tds.get_dataset("UniAttack")(_options(ua), "train", ["OULU-Real"])
    with pytest.raises(ValueError, match="not recognised"):
        ds._subset_of("elsewhere/0.jpg")


MIXED = ["FFpp-Real", "CDF-Fake", "SeqDF-Real", "HQ-Glasses", "OULU-Fake", "SiWMv2-Real"]


def _mixed_items(ds):
    """Items of every source, interleaved, so that a batch mixes six frame
    sizes and both crop rules."""
    by_sub = {}
    for p in ds.images:
        by_sub.setdefault(tds.UniAttack._subset_of(p.split(" ")[0]), []).append(p)
    subs = list(by_sub.values())
    return [s[i] for i in range(max(map(len, subs))) for s in subs if i < len(s)]


def _reads_jpeg_twins(ds, monkeypatch):
    """``ds`` (a JAX UniAttack) reading each Celeb-DF PNG's JPEG twin: a batch
    then takes the JAX package's native decode, which a PNG sends to cv2."""
    read = ds._read_blob_ua
    monkeypatch.setattr(ds, "_read_blob_ua",
                        lambda path, crop: CDF_JPEG.get(path) or read(path, crop))
    return ds


@pytest.mark.parametrize("tf,crop,margin,dmap", [
    ("resize", "nocrop", None, False), ("resize", "4p", 0.3, True),
    ("resize", "4p", (0.0, 0.5), False), ("rrc", "nocrop", None, True),
    ("rrc", "4p", (0.1, 0.6), False),
], ids=["resize-nocrop", "resize-4p-fixed", "resize-4p-drawn", "rrc-nocrop", "rrc-4p-drawn"])
def test_load_item_matches_jax(ua, jax_native, monkeypatch, tf, crop, margin, dmap):
    """Two batches of mixed sources, Celeb-DF's PNG frames among them: the
    plain Resize equal to the JAX package's native decode (which reads the
    PNGs' JPEG twins) and within 1 level of the JAX package's own route for
    a batch holding a PNG (cv2: imdecode, then cv2.resize's fixed-point
    bilinear); RandomResizedCrop with the bicubic resize within 1 level of
    its cv2 path; the keys, the effective crops, the margin and box draws
    (the streams end equal) and the domain labels."""
    opts = _options(ua, train_transforms=TRAIN_TF if tf == "rrc" else RESIZE)
    got_ds, ref_ds = _pair(opts, "train", MIXED)
    twin_ds = _reads_jpeg_twins(jds.UniAttack(copy.deepcopy(opts), "train", MIXED), monkeypatch)
    items = _mixed_items(got_ds)
    dlabel = ({opts[f"{k}_root"]: i for i, k in enumerate(sorted(SIZES))} if dmap else None)
    for sl in (slice(0, 8), slice(8, len(items))):
        batch = items[sl]
        assert any(".png" in item for item in batch)
        got = got_ds.load_item(batch, None, margin=margin, crop=crop, dataset_label_map=dlabel)
        ref = ref_ds.load_item(batch, None, margin=margin, crop=crop, dataset_label_map=dlabel)
        twin = twin_ds.load_item(batch, None, margin=margin, crop=crop, dataset_label_map=dlabel)
        assert got["path"] == ref["path"] == twin["path"]
        assert got["images"].shape == ref["images"].shape == (len(batch), 32, 32, 3)
        d = np.abs(got["images"].astype(np.int32) - twin["images"])
        assert d.max() <= (1 if tf == "rrc" else 0), d.max()
        d = np.abs(got["images"].astype(np.int32) - ref["images"])
        assert d.max() <= 1, d.max()
        if dmap:
            assert got["dataset_labels"].dtype == np.int64
            np.testing.assert_array_equal(got["dataset_labels"], ref["dataset_labels"])
        else:
            assert got["dataset_labels"] is None is ref["dataset_labels"]
    assert got_ds.rng.random() == ref_ds.rng.random() == twin_ds.rng.random()
    assert got_ds.host_tf.rng.random() == ref_ds.host_tf.rng.random()


def test_crop_keys_follow_the_config(ua):
    """The ``_crop`` key whenever the config's crop is nocrop, the path
    otherwise; FF++ and Celeb-DF paths are their keys either way."""
    ds, ref = _pair(_options(ua), "train", MIXED)
    for item in _mixed_items(ds):
        path = item.split(" ")[0]
        for crop in ("nocrop", "4p"):
            assert ds._read_blob_ua(path, crop) == ref._read_blob_ua(path, crop)
        assert ds._convert_to_str(path, "crop") == ref._convert_to_str(path, "crop")
        if tds.UniAttack._subset_of(path) in ("FFpp", "CDF"):
            assert ds._convert_to_str(path, "crop") == path
    with pytest.raises(KeyError, match="Blob missing"):
        ds._read_blob_ua("Oulu_NPU/none.jpg", "nocrop")


# ------------------------------------------------------------ host stage


class Recorder:
    """A numpy Generator that records each draw: (method, args, value)."""

    def __init__(self, seed):
        self.gen, self.calls = np.random.default_rng(seed), []

    def __getattr__(self, name):
        fn = getattr(self.gen, name)

        def record(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((name, args, out))
            return out
        return record


def _same_draws(a, b):
    assert len(a) == len(b) > 0
    for (na, aa, va), (nb, ab, vb) in zip(a, b):
        assert (na, len(aa)) == (nb, len(ab))
        assert all(np.array_equal(x, y) for x, y in zip(aa, ab)), (na, aa, ab)
        assert np.array_equal(va, vb), na


def _port_stage(host, frames):
    """The port's host stage over frames of any size: every frame's draws
    first, then the crop and the resize (cv2 here, the host library in the
    datasets), then :meth:`HostPipeline.apply`."""
    draws = [host.draw(*f.shape[:2]) for f in frames]
    pre = []
    for f, (box, _, _) in zip(frames, draws):
        if box is not None:
            f = f[box[1]:box[3], box[0]:box[2]]
        if f.shape[:2] != (host.height, host.width):
            f = cv2.resize(f, (host.width, host.height), interpolation=host.interpolation)
        pre.append(f)
    return host.apply(np.stack(pre), draws), draws


IC = {"name": "ImageCompression", "params": {"quality_lower": 50, "quality_upper": 60, "p": 0.5}}
HOST_CASES = {
    "distorted": ([RESIZE[0]], True),
    "image-compression": ([RESIZE[0], IC], False),
    "rrc+image-compression": ([RRC, IC], False),
    "rrc+distorted": ([RRC], True),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_stage_matches_jax(case):
    """60 frames of three sizes through the port's stage and the JAX stage
    from one seed: the same draws in the same order (every value, the noise
    arrays included), the same OneOf branch per frame, and the frames: the
    blur within 1 level of cv2.GaussianBlur (mean 0.2), the rest bit for bit
    (the JPEG round trip on the libjpeg build, whose encoder writes
    cv2.imencode's bytes)."""
    tf_list, distorted = HOST_CASES[case]
    host, _ = ttf.build_transforms(tf_list, corrupt_distorted=distorted)
    ref, _ = jtf.build_transforms(tf_list, corrupt_distorted=distorted)
    host.rng, ref.rng = Recorder(5), Recorder(5)
    rng = np.random.default_rng(6)
    frames = [cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (3, 3), 0)
              for h, w in [(32, 32), (40, 44), (37, 29)] * 20]
    got, draws = _port_stage(host, frames)
    at = []  # where each call of the JAX OneOf starts in its stream: its branch draw
    distort = ref._distorted
    ref._distorted = lambda img: at.append(len(ref.rng.calls)) or distort(img)
    want = np.stack([ref(f) for f in frames])
    _same_draws(host.rng.calls, ref.rng.calls)
    branches = [None if o is None else o[0] for _, o, _ in draws]
    if distorted:
        assert all(ref.rng.calls[i][:2] == ("integers", (0, 5)) for i in at)
        assert branches == [int(ref.rng.calls[i][2]) for i in at]
        assert set(branches) == {0, 1, 2, 3, 4}
    if "image-compression" in case:
        qs = [q for _, _, q in draws if q is not None]
        assert 10 < len(qs) < 50 and set(qs) <= set(range(50, 61))
    assert tnative.backend() == "libjpeg"
    for i, b in enumerate(branches):
        d = np.abs(got[i].astype(np.int32) - want[i])
        if b == 1:
            assert d.max() <= 1 and d.mean() <= 0.2, (i, d.max(), d.mean())
        else:
            np.testing.assert_array_equal(got[i], want[i], err_msg=f"frame {i} branch {b}")


@pytest.mark.parametrize("h,w", [(380, 380), (37, 29), (17, 33), (1, 1), (16, 16), (251, 317)])
def test_encoder_writes_cv2s_bytes(h, w):
    """ImageCompression's encoder: libjpeg's colour conversion and chroma
    subsampling on the host (the planes the nvJPEG build encodes too), then
    libjpeg's raw-data encode: cv2.imencode's bytes at the OneOf's qualities,
    at sizes with partial blocks and MCUs."""
    assert tnative.backend() == "libjpeg"
    frame = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    for q in (50, 55, 60, 95):
        want = cv2.imencode(".jpg", frame[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])[1]
        assert tnative.encode_jpeg(frame, q) == want.tobytes(), q


@pytest.mark.parametrize("k", [9, 11])
def test_host_blur_within_a_level_of_cv2(k):
    rng = np.random.default_rng(k)
    for name, img in (("noise", rng.integers(0, 256, (96, 80, 3), dtype=np.uint8)),
                      ("smooth", cv2.GaussianBlur(rng.integers(0, 256, (96, 80, 3),
                                                               dtype=np.uint8), (7, 7), 0))):
        d = np.abs(ttf.blur_u8(img[None], k)[0].astype(np.int32) - cv2.GaussianBlur(img, (k, k), 0))
        print(f"k {k} {name}: max {d.max()}, mean {d.mean():.4f}")
        assert d.max() <= 1 and d.mean() <= 0.2, (name, d.max(), d.mean())


def test_distorted_test_split_loads_through_the_host_oneof(ua):
    """``distorted: true`` corrupts the test split only, on the host: the
    batch is the plain batch with each frame's drawn corruption applied."""
    opts = _options(ua, distorted=True)
    test = tds.UniAttack(copy.deepcopy(opts), "test", ["FFpp-Real", "OULU-Fake"])
    val = tds.UniAttack(copy.deepcopy(opts), "val", ["FFpp-Real", "OULU-Fake"])
    plain = tds.UniAttack(_options(ua), "test", ["FFpp-Real", "OULU-Fake"])
    assert test.host_tf.distorted_oneof and not val.host_tf.distorted_oneof
    assert not test.device_tf.corrupt
    seen = []
    apply = test.host_tf.apply
    test.host_tf.apply = lambda frames, draws: seen.append((frames.copy(), draws)) or apply(
        frames, draws)
    items = test.images[:10]
    got = test.load_item(items, None, crop="nocrop")["images"]
    base = plain.load_item(items, None, crop="nocrop")["images"]
    (frames, draws), = seen
    np.testing.assert_array_equal(frames, base)
    assert [o[0] for _, o, _ in draws] and all(o is not None for _, o, _ in draws)
    assert not np.array_equal(got, base)


# ------------------------------------------------------- device stage


def _jax_corrupt_draws(key, n, shape):
    """The draws of the JAX DevicePipeline(corrupt=True) under ``key``, by its
    own key splits: the OneOf's branch, u, blur size and noise, then the
    flip."""
    key, kc = jax.random.split(key)
    _, kf = jax.random.split(key)
    kidx, kp, kn, kk = jax.random.split(kc, 4)
    col = (n, 1, 1, 1)
    draws = ttf.CorruptDraws(
        branch=torch.tensor(np.array(jax.random.randint(kidx, col, 0, 4)).reshape(n)).long(),
        u=torch.tensor(np.array(jax.random.uniform(kp, col)).reshape(n)),
        k11=torch.tensor(np.array(jax.random.bernoulli(kk, 0.5, col)).reshape(n)),
        noise=torch.tensor(np.array(jax.random.normal(kn, shape))))
    return draws, np.asarray(jax.random.uniform(kf, col)).reshape(n)


@pytest.mark.parametrize("hflip_p", [0.0, 0.5])
def test_device_corruption_matches_jax(hflip_p):
    """DevicePipeline(corrupt=True) with the JAX stage's draws passed in:
    within 1e-5 of JAX's ``_corrupt_oneof`` route, every branch taken."""
    n, shape = 12, (12, 24, 20, 3)
    x = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(4)
    ref = jtf.DevicePipeline(hflip_p=hflip_p, corrupt=True)(jnp.asarray(x), key)
    draws, flip_u = _jax_corrupt_draws(key, n, shape)
    assert set(draws.branch.tolist()) == {0, 1, 2, 3}
    port = ttf.DevicePipeline(hflip_p=hflip_p, corrupt=True)
    flip = torch.from_numpy(flip_u < hflip_p) if hflip_p > 0 else None
    got = port(torch.from_numpy(x), flip_mask=flip, draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # its own draws: one generator, a corrupted batch of the same shape
    gen = torch.Generator().manual_seed(0)
    again = port(torch.from_numpy(x), gen)
    assert again.shape == shape and again.dtype == torch.float32
    assert not torch.equal(again, port(torch.from_numpy(x)))


@pytest.mark.parametrize("k", [9, 11])
def test_blur_matches_jax(k):
    """The corruption's blur (``ops/perturb.gaussian_blur`` at cv2's sigma)
    against the JAX stage's ``_blur``: within 1e-6."""
    x = np.random.default_rng(k).random((2, 20, 24, 3), dtype=np.float32)
    ref = np.asarray(jtf._blur(jnp.asarray(x), k))
    got = gaussian_blur(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_build_transforms_matches_jax_for_the_distorted_split():
    """Prot1's test list with ``corrupt_distorted``, and a list of device
    corruptions with and without it: the same host and device fields."""
    fields = ("height", "width", "jpeg_compress", "jpeg_p", "distorted_oneof", "rrc_scale",
              "interpolation", "is_plain_resize")
    device = [{"name": n, "params": {}} for n in ttf.CORRUPTIONS]
    for tf_list, distorted in ((RESIZE, True), (RESIZE + device, False), (RESIZE + device, True),
                               (TRAIN_TF + [IC], False)):
        th, td = ttf.build_transforms(tf_list, corrupt_distorted=distorted)
        jh, jd = jtf.build_transforms(tf_list, corrupt_distorted=distorted)
        for f in fields:
            assert getattr(th, f) == getattr(jh, f), f
        for f in ("mean", "std", "hflip_p", "corrupt"):
            assert getattr(td, f) == getattr(jd, f), f


# ------------------------------------------------------------- engine


def _config(tmp, roots, run_id, **data):
    ds = _options(roots, num_steps=2, log_steps=1, val_steps=1,
                  train_real_method=["FFpp-Real", "OULU-Real", "HQ-Real"],
                  train_fake_method=["FFpp-DF", "OULU-Fake", "HQ-Glasses"],
                  val_real_method=["FFpp-Real", "SiWMv2-Real"],
                  val_fake_method=["FFpp-DF", "SiWMv2-Fake"],
                  test_method=["FFpp-Real", "FFpp-F2F", "CDF-Real", "SeqDF-Fake"])
    ds.update(data)
    ds_path = os.path.join(tmp, f"data-{run_id}.yml")
    with open(ds_path, "w") as f:
        yaml.safe_dump(ds, f)
    return {
        "model": {"name": "UDR18", "num_classes": 2, "drop_rate": 0.5, "extractor": "resnet18",
                  "extractor_weights": "ckpt/resnet18.pth"},
        "config": {
            "local_rank": 0, "num_devices": 1, "lambda_triplet": 0.1, "lambda_recons": 0.1,
            "lambda_freq": 1.0, "lambda_mask": 0.1, "lambda_fac": 0.1,
            "optimizer": {"name": "adamw", "lr": 1e-4, "betas": [0.9, 0.999],
                          "weight_decay": 5e-6, "amsgrad": True},
            "crop": "nocrop", "warmup_step": 0, "resume": False, "id": run_id, "debug": False,
            "offline": True, "use_domain_label": True,
        },
        "data": {"train_batch_size": 2, "val_batch_size": 8, "test_batch_size": 12,
                 "num_workers": 1, "file": ds_path},
        "cfg_path": ds_path,
    }


@pytest.fixture(scope="module")
def engines(ua, tmp_path_factory):
    """The JAX UniAttackEngine and the port's from one config (no JAX train
    step is compiled), in a working directory of their own."""
    from unidefense_tpu.engines import get_engine as jax_get_engine

    with module_tmp(tmp_path_factory, "ue-engines") as path:
        tmp = str(path)
        cwd, stdout = os.getcwd(), sys.stdout
        os.chdir(tmp)
        try:
            ref = jax_get_engine("UE")(_config(tmp, ua, "jax-run"), stage="Train")
            got = get_engine("UE")(_config(tmp, ua, "port-run"), stage="Train", device="cpu")
        finally:
            sys.stdout = stdout
            os.chdir(cwd)
        yield got, ref


def test_streams_and_domain_map_match_jax(engines):
    """Steps 1-3 of the real and fake streams: the same selections, the
    labels real first, the images within 1 level (RandomResizedCrop
    bicubic against cv2); the same domain map."""
    got, ref = engines
    assert got.dlabel_map == ref.dlabel_map and len(got.dlabel_map) == 3
    for step in (1, 2, 3):
        g_sel, r_sel = got._select_batch(step), ref._select_batch(step)
        # the port plans each load as it selects: its selection holds the plan
        assert [s[0]["path"] for s in g_sel] == [[i.split(" ")[0] for i in s[0]] for s in r_sel]
        g, r = got._load_batch(g_sel), ref._load_batch(r_sel)
        np.testing.assert_array_equal(g["label"].numpy(), [0, 0, 1, 1])
        np.testing.assert_array_equal(g["label"].numpy(), np.asarray(r["label"]))
        d = np.abs(g["image"].numpy().astype(np.int32) - np.asarray(r["image"]))
        assert g["image"].shape == (4, 32, 32, 3) and d.max() <= 1, d.max()


def test_val_threshold_and_test_metrics_match_jax(engines, jax_native, monkeypatch, capsys):
    """The validation threshold and the test metrics at it, from the same
    weights (UDR18, random BatchNorm statistics and scales, a wider
    classifier), the JAX engine's validation flips off, both decoding
    through the same libjpeg code (the JAX engine reads the Celeb-DF PNGs'
    JPEG twins, since the JAX package resizes a batch holding a PNG with
    cv2's fixed-point bilinear): per-video probabilities within 1e-5;
    EER, ACER, AUC, APCER and BPCER within 1e-9; the thresholds, which are
    probabilities, within the probabilities' 1e-5."""
    from unidefense_tpu.utils.metrics import cal_metrics as jax_cal_metrics

    got, ref = engines
    v = {"params": jax.tree.map(np.asarray, ref.state.params),
         "batch_stats": jax.tree.map(np.asarray, ref.state.batch_stats)}
    v = _scaled(_randomise(v, classifier_std=0.05))
    got.state.model.load_state_dict(state_dict_from_jax(v), strict=True)
    # spread the bottleneck's statistics over the validation and test frames
    model, seen = got.state.model, []
    hook = model.bottleneck.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    model.eval()
    try:
        for ds in (got.val_real_set, got.val_fake_set, got.test_set):
            got.eval_step(torch.from_numpy(ds.load_item(ds.images, None)["images"]))
    finally:
        hook.remove()
        model.train()
    f = torch.cat(seen).double().numpy()
    bn = v["batch_stats"]["bottleneck"]
    bn["mean"], bn["var"] = f.mean(0).astype(np.float32), (f.var(0) + 1e-6).astype(np.float32)
    got.state.model.load_state_dict(state_dict_from_jax(v), strict=True)
    ref.state = ref.state.replace(params=v["params"], batch_stats=v["batch_stats"])
    ref.train_real_set.device_tf.hflip_p = 0.0
    _reads_jpeg_twins(ref.test_set, monkeypatch)
    assert any(".png" in p for p in got.test_set.images)

    g = got.gather_eval_output(*got.score_dataset(got.test_set, 12, {"crop": "nocrop"}, 0))
    r = ref.gather_eval_output(*ref.score_dataset(ref.test_set, 12, {"crop": "nocrop"}, 0))
    assert g["video_tgt"] == r["video_tgt"] and len(g["video_tgt"]) == 10
    np.testing.assert_allclose(g["video_prob"], r["video_prob"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g["frame_prob"], r["frame_prob"], rtol=0, atol=1e-5)
    assert np.ptp(r["frame_prob"]) > 1e-3  # the frames' probabilities do differ

    m_got, m_ref = got._val_threshold(3), ref._val_threshold(3)
    (v_got, f_got), (v_ref, f_ref) = got._test_metrics(3, m_got["Thre"]), \
        ref._test_metrics(3, m_ref["Thre"])
    for got_m, ref_m in ((m_got, m_ref), (v_got, v_ref), (f_got, f_ref)):
        for k in ("EER", "ACER", "AUC", "APCER", "BPCER", "NumP", "NumN"):
            assert got_m[k] == pytest.approx(ref_m[k], abs=1e-9), k
        assert got_m["Thre"] == pytest.approx(ref_m["Thre"], abs=1e-5)
    assert 0.0 < m_ref["Thre"] < 1.0
    assert jax_cal_metrics(np.asarray(r["frame_tgt"]), np.asarray(r["frame_prob"]),
                           threshold=m_ref["Thre"])["ACER"] == pytest.approx(f_got["ACER"])
    out = capsys.readouterr().out
    assert "Eval Step 3 [Frame], ACER" in out and "Test Step 3 [Video], EER" in out
    assert "Test Step 3 [Frame], EER" in out and "APCER" in out


def test_uniattack_engine_lifecycle(ua, tmp_path, monkeypatch, capsys):
    """The default engine (no ``--engine``: UE) through main on the CPU:
    2 steps validated at each, the best checkpoint by the least test frame
    ACER, ``--test`` on the distorted test split from it; then a resume that
    restores the best metrics and threshold and whose streams select at
    steps 3 and 4 what an uninterrupted run selects."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmain, "get_engine",
                        lambda name: functools.partial(get_engine(name), device="cpu"))
    cfg = _config(str(tmp_path), ua, "life")
    model_yml = tmp_path / "model.yml"
    with open(model_yml, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.items() if k != "cfg_path"}, f)
    argv = ["--config", str(model_yml), "--offline"]
    engine = tmain.main(argv)
    out = capsys.readouterr().out
    assert type(engine).__name__ == "UniAttackEngine" and engine.device.type == "cpu"
    assert engine.state.step == 2 and "Train Iter (2/2)" in out
    evals = [ln for ln in out.splitlines() if ln.startswith("Eval Step")]
    tests = [ln for ln in out.splitlines() if ln.startswith("Test Step")]
    assert len(evals) == 2 and len(tests) == 4 and "Best ACER F" in out
    acers = [float(ln.split("ACER ")[1].split(",")[0]) for ln in tests if "[Frame]" in ln]
    assert engine.best_step == (2 if acers[1] < acers[0] else 1)
    assert engine.ckpt.exists(best=True) and engine.ckpt.exists(best=False)

    distorted = _config(str(tmp_path), ua, "life-distorted", distorted=True)["data"]["file"]
    tested = tmain.main(argv + ["--test", "--ds_config", distorted])
    out = capsys.readouterr().out
    assert f"Loaded best checkpoint: step {engine.best_step}." in out
    assert "Summary:" in out and "[Video] ACER" in out and "[Frame] ACER" in out
    assert tested.test_set.host_tf.distorted_oneof and tested.val_batch_size == 12

    def run(run_id, steps, **config):
        c = _config(str(tmp_path), ua, run_id, num_steps=steps)
        c["config"].update(config)
        return get_engine("UE")(c, device="cpu")

    resumed = run("life", 4, resume=True)
    assert resumed.start_step == 3 and resumed.state.step == 2
    for key in ("best_step", "best_hter_frame", "best_hter_video", "best_auc_frame",
                "best_auc_video", "best_thres"):
        assert getattr(resumed, key) == getattr(engine, key), key
    straight = run("straight", 4)
    want = [straight._select_batch(s) for s in (1, 2, 3, 4)][2:]
    resumed._make_prefetcher()  # fast-forwards both streams to step 3
    for step, sels in zip((3, 4), want):
        assert [s[0]["path"] for s in resumed._select_batch(step)] == \
            [s[0]["path"] for s in sels], step


@pytest.mark.parametrize("entry", ["engine", "main"])
def test_ue_defaults_to_cuda_and_raises_without_a_card(ua, tmp_path, monkeypatch, entry):
    """``get_engine("UE")`` (device=None) and the CLI's default engine refuse
    to run without a card, before they read a dataset or write a run
    directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg = _config(str(tmp_path), ua, "no-card")
    model_yml = tmp_path / "model.yml"
    with open(model_yml, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.items() if k != "cfg_path"}, f)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "engine":
            get_engine("UE")(cfg, stage="Train")
        else:
            tmain.main(["--config", str(model_yml), "--offline"])
    assert not (tmp_path / "runs").exists()


def test_index_pickles_are_read_as_plain_pickles_too(ua, tmp_path):
    """An index written with pickle (not torch.save) loads the same."""
    roots = dict(ua)
    seq = tmp_path / "SeqDF"
    (seq / "pickle_files").mkdir(parents=True)
    (seq / "lmdb").symlink_to(os.path.join(ua["SeqDF_root"], "lmdb"))
    for label in ("real", "fake"):
        items = torch.load(os.path.join(ua["SeqDF_root"], "pickle_files",
                                        f"train_{label}.pickle"), weights_only=False)
        with open(seq / "pickle_files" / f"train_{label}.pickle", "wb") as f:
            pickle.dump(items, f)
    roots["SeqDF_root"] = str(seq)
    got = tds.UniAttack(_options(roots), "train", ["SeqDF-Real", "SeqDF-Fake"])
    ref = tds.UniAttack(_options(ua), "train", ["SeqDF-Real", "SeqDF-Fake"])
    assert got.images == ref.images and len(got) == 12
