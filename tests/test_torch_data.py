"""The port's host data path against the JAX package's, on a synthetic FF++
tree written with cv2: the FF++ index, the sampler and batcher streams, the
FrameStore format, the host JPEG library (bit for bit against
native/udjpeg.cc, within one level of the cv2 path), the encoder and the
transform list."""

import ctypes
import os
import subprocess

import cv2
import numpy as np
import pytest
import torch

from unidefense_torch.data import datasets as tds
from unidefense_torch.data import native as tnative
from unidefense_torch.data import pipeline as tpipe
from unidefense_torch.data import store as tstore
from unidefense_torch.data import transforms as ttf
from unidefense_tpu.data import datasets as jds
from unidefense_tpu.data import native as jnative
from unidefense_tpu.data import pipeline as jpipe
from unidefense_tpu.data import store as jstore
from unidefense_tpu.data import transforms as jtf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL = "original_sequences/youtube/c23/images/{v:03d}/{f:04d}.jpg"
FAKE = "manipulated_sequences/Deepfakes/c23/images/{v:03d}_x/{f:04d}.jpg"
TRANSFORMS = [
    {"name": "Resize", "params": {"height": 32, "width": 32}},
    {"name": "HorizontalFlip", "params": {"p": 0.5}},
    {"name": "Normalize", "params": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}},
]


def write_ffpp(root, videos=4, frames=6, size=(40, 44)):
    """An FF++ tree: `videos` real and fake videos of `frames` JPEG frames of
    seeded noise (cv2.imwrite), and the three split pickles."""
    index = []
    for label, pattern in ((0, REAL), (1, FAKE)):
        for v in range(videos):
            for f in range(frames):
                rel = pattern.format(v=v, f=f)
                img = np.random.default_rng(500 * label + 10 * v + f).integers(
                    0, 256, (*size, 3), dtype=np.uint8)
                path = os.path.join(root, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                cv2.imwrite(path, img)
                index.append((rel, label))
    os.makedirs(os.path.join(root, "pickle_files"), exist_ok=True)
    for split in ("train", "val", "test"):
        torch.save(index, os.path.join(root, "pickle_files", f"{split}_c23.pickle"))
    return str(root)


@pytest.fixture(scope="module")
def ffpp(tmp_path_factory):
    return write_ffpp(tmp_path_factory.mktemp("ffpp"))


@pytest.fixture(scope="module")
def udjpeg(tmp_path_factory):
    """native/udjpeg.cc built into a temporary directory (the JAX package's
    Makefile flags)."""
    out = tmp_path_factory.mktemp("udjpeg") / "libudjpeg.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
                    os.path.join(ROOT, "native", "udjpeg.cc"), "-o", str(out), "-shared",
                    "-ljpeg", "-lpthread"], check=True)
    return str(out)


@pytest.fixture
def jax_native(udjpeg, monkeypatch):
    """The JAX package's decode_batch through native/udjpeg.cc."""
    monkeypatch.setenv("UDJPEG_LIB", udjpeg)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    assert jnative.get_lib() is not None
    return jnative.decode_batch


def _cfg(root, **kw):
    cfg = {"root": root, "use_lmdb": False, "method": ["Origin", "Deepfakes"],
           "compression": "c23", "train_transforms": TRANSFORMS,
           "val_transforms": [TRANSFORMS[0], TRANSFORMS[2]]}
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("split,method,fpv", [
    ("train", ["Origin"], 4), ("train", ["Deepfakes"], 3), ("val", ["Origin", "Deepfakes"], None),
    ("test", ["Deepfakes"], None)])
def test_faceforensics_index_matches_jax(ffpp, split, method, fpv):
    cfg = _cfg(ffpp, method=method, **{f"{split}_fpv": fpv})
    got, ref = tds.FaceForensics(dict(cfg), split), jds.FaceForensics(dict(cfg), split)
    assert [str(p) for p in got.images] == [str(p) for p in ref.images]
    assert got.targets == ref.targets
    assert len(got) == (4 * (fpv or 6) if len(method) == 1 else 48)


def _stream(mod, n, bs, shard, nshards, steps, start=1):
    ds = type("DS", (), {"targets": list(range(n)), "__getitem__": lambda self, i: (f"f{i}", i)})()
    sampler = mod.EpochSampler(n, bs, shuffle=True, pad_last=True, shard_id=shard,
                               num_shards=nshards, seed=3)
    batcher = mod.InfiniteBatcher(ds, sampler)
    batcher.fast_forward(start)
    return [batcher.select(s) for s in range(start, steps + 1)]


@pytest.mark.parametrize("n,bs,shards,start", [(22, 4, 1, 1), (22, 4, 2, 1), (9, 4, 3, 1),
                                               (22, 4, 1, 5), (3, 4, 1, 1)])
def test_sampler_and_batcher_match_jax(n, bs, shards, start):
    """Three epochs (or more steps) of selections, padded last batches,
    shards and a fast-forwarded start."""
    steps = 3 * -(-(-(-n // shards)) // bs) + 2
    for shard in range(shards):
        got = _stream(tpipe, n, bs, shard, shards, steps, start)
        ref = _stream(jpipe, n, bs, shard, shards, steps, start)
        assert len(got) == len(ref) == steps - start + 1
        for (gi, gl), (ri, rl) in zip(got, ref):
            assert gi == ri
            np.testing.assert_array_equal(gl, rl)
            assert len(gi) == bs


def test_sampler_torch_order_matches_jax(monkeypatch):
    monkeypatch.setenv("UD_SAMPLER_TORCH_ORDER", "1")
    assert _stream(tpipe, 13, 4, 0, 1, 9)[-1][0] == _stream(jpipe, 13, 4, 0, 1, 9)[-1][0]


def test_prefetcher_yields_in_step_order():
    pre = tpipe.BatchPrefetcher(select=lambda s: s, load=lambda s: {"step": s}, depth=3,
                                num_steps=9, start_step=2, workers=3)
    assert [b["step"] for b in pre] == list(range(2, 10))


@pytest.mark.parametrize("writer,reader", [(tstore, jstore), (jstore, tstore)],
                         ids=["port-writes", "jax-writes"])
def test_frame_store_cross_reads(tmp_path, writer, reader):
    path = str(tmp_path / "lmdb" / "frames.udb")
    blobs = {f"key/{i}": bytes(np.random.default_rng(i).integers(0, 256, i + 1, dtype=np.uint8))
             for i in range(12)}
    with writer.FrameStoreWriter(path) as w:
        for k, v in blobs.items():
            w.add(k, v)
    store = reader.open_blob_source(str(tmp_path), "frames")
    assert len(store) == len(blobs) and set(store.keys()) == set(blobs)
    for k, v in blobs.items():
        assert store.get(k) == v
    assert store.get("missing") is None
    store.close()


def test_missing_blob_source_raises_like_jax(tmp_path):
    with pytest.raises(FileNotFoundError) as got:
        tstore.open_blob_source(str(tmp_path), "none")
    with pytest.raises(FileNotFoundError) as ref:
        jstore.open_blob_source(str(tmp_path), "none")
    assert str(got.value) == str(ref.value)


def _jpegs(n=8, seed=0):
    """JPEG blobs of several sizes and chroma layouts: cv2's 4:2:0 and grey,
    and 4:4:4 / 4:2:2 through cv2's sampling-factor flag."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = int(rng.integers(9, 70)), int(rng.integers(9, 70))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 2:
            img = cv2.GaussianBlur(img, (5, 5), 0)
        params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(50, 100))]
        if i % 4 == 1:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
        elif i % 4 == 2:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]
        out.append(cv2.imencode(".jpg", img[:, :, 0] if i % 7 == 6 else img, params)[1].tobytes())
    return out


BOXES = np.array([[2, 3, 30, 33], [-1, -1, -1, -1], [0, 0, 90, 90], [5, 5, 20, 40],
                  [-3, -4, 10, 10], [8, 1, 8, 50], [1, 1, 9, 9], [3, 0, 40, 12]], np.int32)


@pytest.mark.parametrize("out_hw", [(32, 32), (24, 40), (64, 48)])
def test_decoder_matches_jax_native_bitwise(jax_native, out_hw):
    blobs = _jpegs()
    for boxes in (BOXES, None):
        got = tnative.decode_batch(blobs, boxes, *out_hw)
        ref = jax_native(blobs, boxes, *out_hw)
        np.testing.assert_array_equal(got, ref)


def test_decoder_within_one_level_of_cv2(monkeypatch):
    """Against the JAX package's cv2 path (imdecode, crop, cv2.resize)."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    blobs = _jpegs(seed=1)
    got = tnative.decode_batch(blobs, BOXES, 36, 30).astype(np.int32)
    ref = jnative.decode_batch(blobs, BOXES, 36, 30).astype(np.int32)
    assert np.abs(got - ref).max() <= 1


def test_encoder_round_trip():
    """The port's encoder writes what cv2.imencode writes (on libjpeg), and
    its frames decode to within JPEG's error of the source."""
    yy, xx = np.mgrid[0:48, 0:56]
    frame = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1).astype(np.uint8)
    blob = tnative.encode_jpeg(frame, 95)
    back = tnative.decode_batch([blob], None, 48, 56)[0]
    assert np.abs(back.astype(int) - frame).mean() < 2.0
    np.testing.assert_array_equal(back, cv2.imdecode(np.frombuffer(blob, np.uint8),
                                                     cv2.IMREAD_COLOR)[:, :, ::-1])
    if tnative.backend() == "libjpeg":
        assert blob == cv2.imencode(".jpg", frame[:, :, ::-1])[1].tobytes()


def test_decoder_refuses_non_jpeg():
    png = cv2.imencode(".png", np.zeros((4, 4, 3), np.uint8))[1].tobytes()
    with pytest.raises(NotImplementedError, match="queue 3"):
        tnative.decode_batch([png], None, 4, 4)


@pytest.mark.parametrize("crop,margin", [("nocrop", None), ("4p", 0.4), ("4p", (0.2, 0.8))])
def test_load_item_matches_jax(ffpp, jax_native, crop, margin):
    cfg = _cfg(ffpp)
    got_ds, ref_ds = tds.FaceForensics(dict(cfg), "val"), jds.FaceForensics(dict(cfg), "val")
    items = [f"{p} 0 {3 + i} {2 + i} {20 + i} {24 - i}" for i, p in enumerate(got_ds.images[::5])]
    labels = [0] * len(items)
    for _ in range(2):  # the second call draws a second margin
        got = got_ds.load_item(items, labels, margin=margin, crop=crop)
        ref = ref_ds.load_item(items, labels, margin=margin, crop=crop)
        assert got["path"] == ref["path"]
        np.testing.assert_array_equal(got["images"], ref["images"])
    contents = items[0].split(" ")
    assert got_ds._box_for(contents, 0.4, crop) == ref_ds._box_for(contents, 0.4, crop)


def test_build_transforms_matches_jax():
    th, td = ttf.build_transforms(TRANSFORMS)
    jh, jd = jtf.build_transforms(TRANSFORMS)
    assert (th.height, th.width) == (jh.height, jh.width)
    assert (td.mean, td.std, td.hflip_p) == (jd.mean, jd.std, jd.hflip_p)
    # the port's host stage is the decoder's resize: against JAX's on the
    # frame cv2 decodes
    frame = np.random.default_rng(2).integers(0, 256, (40, 44, 3), dtype=np.uint8)
    blob = cv2.imencode(".jpg", frame)[1].tobytes()
    decoded = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
    got = tnative.decode_batch([blob], None, th.height, th.width)[0]
    assert np.abs(got.astype(int) - jh(np.ascontiguousarray(decoded))).max() <= 1


@pytest.mark.parametrize("name", ["RandomResizedCrop", "ImageCompression", "GaussianBlur",
                                  "GaussNoise", "RandomBrightnessContrast", "ColorJitter",
                                  "OneOf"])
def test_unported_transforms_raise(name):
    with pytest.raises(NotImplementedError, match="queue 3"):
        ttf.build_transforms([{"name": name, "params": {"height": 8, "width": 8}}])


@pytest.mark.parametrize("name", ["CDF", "WDF", "OCIM", "UniAttack"])
def test_unported_datasets_raise(name):
    with pytest.raises(NotImplementedError, match="queue 3"):
        tds.get_dataset(name)({}, "train")


def test_host_library_is_built_from_the_checkout():
    lib = tnative.get_lib()
    assert isinstance(lib, ctypes.CDLL) and tnative.backend() in ("libjpeg", "nvjpeg")
