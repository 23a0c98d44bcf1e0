"""The port's host data path against the JAX package's, on a synthetic FF++
tree written with cv2: the FF++ index, the sampler and batcher streams, the
FrameStore format, the host JPEG library (bit for bit against
native/udjpeg.cc, within one level of the cv2 path), its PNG decoder (bit
for bit against cv2 and Pillow), the encoder and the transform list."""

import ctypes
import io
import os
import struct
import subprocess
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

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
    # the port's batcher plans each load as it selects (``plan_item``); this
    # dataset's plan is its items
    ds = type("DS", (), {"targets": list(range(n)), "__getitem__": lambda self, i: (f"f{i}", i),
                         "plan_item": lambda self, items, labels: items})()
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
    """A frame that is neither JPEG nor PNG (here a BMP) raises, in a batch
    and for its size."""
    bmp = cv2.imencode(".bmp", np.zeros((4, 4, 3), np.uint8))[1].tobytes()
    with pytest.raises(NotImplementedError, match="JPEG and PNG"):
        tnative.decode_batch([bmp], None, 4, 4)
    with pytest.raises(NotImplementedError, match="JPEG and PNG"):
        tnative.jpeg_dims([_jpegs()[0], bmp])


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_filter(row, prev, bpp, f):
    """One scanline under PNG filter ``f`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), from the raw bytes of the row and the row above."""
    r, up = row.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    corner = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
    if f == 4:
        pa, pb, pc = np.abs(up - corner), np.abs(left - corner), np.abs(left + up - 2 * corner)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
    else:
        pred = [0 * r, left, up, (left + up) >> 1][f]
    return ((r - pred) & 255).astype(np.uint8)


# Adam7's seven reduced images in stream order: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _png_rows(samples, depth):
    """The raw scanline bytes of ``samples`` (H, W[, C]) at ``depth`` bits."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth >= 8:
        return flat.astype(np.uint8 if depth == 8 else ">u2").view(np.uint8).reshape(h, -1)
    rows = np.zeros((h, (flat.shape[1] * depth + 7) // 8), np.uint8)
    for x in range(flat.shape[1]):
        rows[:, x * depth // 8] |= (flat[:, x] << (8 - depth - x * depth % 8)).astype(np.uint8)
    return rows


def png_bytes(samples, depth, colour, level=6, filters=(0,), palette=None, extra=b"",
              interlace=0):
    """A PNG written here byte by byte (no cv2, no Pillow): ``samples``
    (H, W, C) of ``depth`` bits, or (H, W) palette indices for colour type
    3; the rows filtered by ``filters`` in turn, zlib at ``level`` (0 writes
    stored blocks), the stream split over IDAT chunks of 997 bytes, and
    ``extra`` chunks before them. ``interlace=1`` writes Adam7: the seven
    reduced images in turn, each filtered as an image of its own (its first
    row against zeros, ``filters`` from its first row), empty ones left
    out."""
    h, w = samples.shape[:2]
    channels = 1 if samples.ndim == 2 else samples.shape[2]
    bpp = max(1, channels * depth // 8)
    data = bytearray()
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _png_rows(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for y in range(rows.shape[0]):
            f = filters[y % len(filters)]
            data += bytes([f]) + _png_filter(rows[y], prev, bpp, f).tobytes()
            prev = rows[y]
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                                  colour, 0, 0, interlace)) + extra
    if palette is not None:
        out += _png_chunk(b"PLTE", palette.tobytes())
    z = zlib.compress(bytes(data), level)
    for at in range(0, len(z), 997):
        out += _png_chunk(b"IDAT", z[at:at + 997])
    return out + _png_chunk(b"IEND", b"")


def _decodes_as_cv2(blob, pillow=True):
    """The frame as the host library decodes it at its own size, held bit for
    bit against cv2.imdecode(IMREAD_COLOR) and Pillow's RGB, and its size
    from the header."""
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
    h, w = want.shape[:2]
    np.testing.assert_array_equal(tnative.jpeg_dims([blob]), [[h, w]])
    got = tnative.decode_batch([blob], None, h, w)[0]
    np.testing.assert_array_equal(got, want)
    if pillow:
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")))


# (colour type, bit depth): every layout PNG allows; each plain and Adam7
PNG_LAYOUTS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
               (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
PNG_CASES = [(c, d, i) for i in (0, 1) for c, d in PNG_LAYOUTS]


@pytest.mark.parametrize("colour,depth,interlace", PNG_CASES,
                         ids=[f"type{c}-{d}bit" + ("-adam7" if i else "") for c, d, i in PNG_CASES])
def test_png_decodes_as_cv2_and_pillow(colour, depth, interlace):
    """PNG frames (the frames of Celeb-DF): every colour type and bit depth,
    plain and interlaced (Adam7), each row filter alone and all five in
    turn, stored, fast and best zlib blocks, an ancillary chunk, frame sizes
    down to 1x1 (where six of Adam7's seven passes are empty), bit for bit
    as cv2 decodes them in colour (16-bit samples to their high byte;
    Pillow reads those otherwise, so it is held at 8 bits and below)."""
    rng = np.random.default_rng(colour * 17 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    for h, w in ((7, 13), (31, 17), (1, 1), (40, 52)):
        palette = None
        if colour == 3:
            palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
            samples = rng.integers(0, 1 << depth, (h, w))
        else:
            samples = rng.integers(0, 1 << depth, (h, w, channels))
        for level in (0, 1, 9):
            for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
                extra = _png_chunk(b"tEXt", b"key\x00value") if level == 1 else b""
                _decodes_as_cv2(png_bytes(samples, depth, colour, level, filters, palette, extra,
                                          interlace), pillow=depth <= 8)


def test_png_from_cv2_and_pillow():
    """PNGs as cv2 and Pillow write them (adaptive filters, long matches,
    several IDAT chunks), in Pillow's RGB, RGBA, L, LA and P modes and at
    cv2's compression levels: bit for bit as cv2 decodes them."""
    rng = np.random.default_rng(3)
    for h, w in ((320, 320), (37, 29)):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 0)
        for level in (0, 1, 3, 9):
            _decodes_as_cv2(cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])[1]
                            .tobytes())
        for mode in ("RGB", "RGBA", "L", "LA", "P"):
            for optimize in (False, True):
                buf = io.BytesIO()
                Image.fromarray(img).convert(mode).save(buf, format="PNG", optimize=optimize)
                _decodes_as_cv2(buf.getvalue())


@pytest.mark.parametrize("interp", [tnative.INTER_LINEAR, tnative.INTER_CUBIC])
def test_png_crops_and_resizes_as_its_jpeg_twin(interp):
    """A PNG of the pixels a JPEG decodes to is cropped and resized to the
    same frame, bit for bit, whether the batch mixes both formats or not."""
    rng = np.random.default_rng(4)
    jpeg = tnative.encode_jpeg(rng.integers(0, 256, (300, 260, 3), dtype=np.uint8), 95)
    pixels = tnative.decode_batch([jpeg], None, 300, 260)[0]
    png = cv2.imencode(".png", pixels[:, :, ::-1])[1].tobytes()
    boxes = np.asarray([[10, 20, 200, 250], [-5, -5, 400, 400], [-1, -1, -1, -1]], np.int32)
    want = tnative.decode_batch([jpeg] * 3, boxes, 380, 380, interp=interp)
    for blobs in ([png] * 3, [png, jpeg, png], [jpeg, png, jpeg]):
        np.testing.assert_array_equal(tnative.decode_batch(blobs, boxes, 380, 380,
                                                           interp=interp), want)
    np.testing.assert_array_equal(tnative.jpeg_dims([jpeg, png]), [[300, 260], [300, 260]])


def test_broken_png_raises():
    """A damaged IDAT (its CRC), a cut stream, a bad zlib check, an unknown
    critical chunk, and an interlaced frame cut short, raise IOError; an
    interlaced frame whole decodes as cv2 decodes it."""
    samples = np.random.default_rng(5).integers(0, 256, (24, 20, 3))
    good = png_bytes(samples, 8, 2, level=6, filters=(4,))
    bad = bytearray(good)
    bad[60] ^= 0xFF
    interlaced = png_bytes(samples, 8, 2, level=6, filters=(4,), interlace=1)
    _decodes_as_cv2(interlaced)
    unknown = good[:33] + _png_chunk(b"ABCD", b"x") + good[33:]
    z = zlib.compress(b"\x00" * (24 * 61))
    bad_adler = (good[:33] + _png_chunk(b"IDAT", z[:-1] + bytes([z[-1] ^ 1]))
                 + _png_chunk(b"IEND", b""))
    for blob in (bytes(bad), good[:len(good) // 2], interlaced[:len(interlaced) // 2], unknown,
                 bad_adler):
        with pytest.raises(IOError):
            tnative.decode_batch([good, blob], None, 24, 20)
    assert tnative.decode_batch([good, interlaced], None, 24, 20).shape == (2, 24, 20, 3)


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


@pytest.mark.parametrize("name", ["ImageCompression", "GaussianBlur", "GaussNoise",
                                  "RandomBrightnessContrast", "ColorJitter", "OneOf"])
def test_unported_transforms_raise(name):
    """Each transform that raised before the UniAttack path was ported now
    builds the JAX package's stages: the same host and device fields, with
    and without ``corrupt_distorted``."""
    params = {"height": 8, "width": 8, "quality_lower": 40, "quality_upper": 70, "p": 0.3}
    for distorted in (False, True):
        th, td = ttf.build_transforms([{"name": name, "params": params}], distorted)
        jh, jd = jtf.build_transforms([{"name": name, "params": params}], distorted)
        for f in ("height", "width", "jpeg_compress", "jpeg_p", "distorted_oneof",
                  "is_plain_resize"):
            assert getattr(th, f) == getattr(jh, f), f
        for f in ("mean", "std", "hflip_p", "corrupt"):
            assert getattr(td, f) == getattr(jd, f), f
    assert th.distorted_oneof and not td.corrupt


@pytest.mark.parametrize("name", ["CDF", "WDF", "UniAttack"])
def test_unported_datasets_raise(name, ffpp, tmp_path):
    """Each dataset that raised before it was ported now builds as the JAX
    package builds it: Celeb-DF and WildDeepfake (their splits, index and
    loading: tests/test_torch_serving.py) refuse the split they lack as
    the JAX classes do; UniAttack is built from an FF++ index and
    FrameStore."""
    if name != "UniAttack":
        cfg = {"root": str(tmp_path), "method": []}
        assert tds.get_dataset(name).__name__ == jds.get_dataset(name).__name__
        for ds in (tds.get_dataset(name), jds.get_dataset(name)):
            with pytest.raises(ValueError, match="split"):
                ds(dict(cfg), "val")
        return
    root = tmp_path / "FaceForensics++"
    (root / "pickle_files").mkdir(parents=True)
    index = torch.load(os.path.join(ffpp, "pickle_files", "train_c23.pickle"), weights_only=False)
    torch.save(index, root / "pickle_files" / "train_c23.pickle")
    (root / "lmdb").mkdir()
    with tstore.FrameStoreWriter(str(root / "lmdb" / "FaceForensics++.udb")) as w:
        for rel, _ in index:
            with open(os.path.join(ffpp, rel), "rb") as f:
                w.add(rel, f.read())
    cfg = {"root": str(tmp_path), "FFpp_root": str(root), "train_real_fpv": 2,
           "train_fake_fpv": 3, "train_transforms": [TRANSFORMS[0]]}
    methods = ["FFpp-Real", "FFpp-DF"]
    got = tds.get_dataset(name)(dict(cfg), "train", methods)
    ref = jds.get_dataset(name)(dict(cfg), "train", methods)
    assert got.images == ref.images and got.targets == ref.targets and len(got) == 20
    out = got.load_item(got.images[:3], None)
    assert out["images"].shape == (3, 32, 32, 3) and out["dataset_labels"] is None


def test_host_library_is_built_from_the_checkout():
    lib = tnative.get_lib()
    assert isinstance(lib, ctypes.CDLL) and tnative.backend() in ("libjpeg", "nvjpeg")
