"""Launch geometry of K1 (``csrc/normalize_flip.cu``), which the kernel takes
from ``ops/preprocess.normalize_flip_geometry``, and a numpy emulation of
what the kernel does with it: 16-byte tile loads into a ring in shared
memory, 16-byte output vectors whose values step row and position from one
division per vector and cycle through three channels, one shared load for a
vector inside an unflipped row, reversed byte reads of flipped rows from the shared
copy, and the scalar path for the rows after the last full tile and for an
input that is not 16-byte aligned. The kernel runs only on the card; here
the emulation must give ``normalize_flip_plain``'s output bit for bit."""

import ctypes

import numpy as np
import pytest
import torch

from unidefense_torch.ops import _build, preprocess
from unidefense_torch.ops.preprocess import normalize_flip_geometry, normalize_flip_plain

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
DTYPES = [torch.float32, torch.bfloat16]
_dt_ids = ["fp32", "bf16"]

# (N, H, W): serving (32) and training (20) batches and one frame at 380² and
# 256²; N*H not a multiple of R; W = 1 (a 16-byte vector spans rows); N*H
# below R (every row scalar); odd W whose smallest tile is over 20 KB (every
# row scalar); a wide row (R = 1)
CARD_SHAPES = [(n, s, s) for s in (380, 256) for n in (1, 20, 32)] + [
    (3, 7, 13), (4, 5, 1), (1, 1, 1), (2, 3, 7), (1, 3, 427), (1, 10, 2000)]


@pytest.mark.parametrize("out_dtype", DTYPES, ids=_dt_ids)
@pytest.mark.parametrize("n,h,w", CARD_SHAPES, ids=lambda v: str(v))
def test_normalize_flip_geometry_fits_the_card(n, h, w, out_dtype):
    """Tiles cover every row exactly once, a full tile is a whole number of
    16-byte vectors in and out, R is the smallest such count times the
    rounding towards 8 KB, and two tiles with their flip bits fit 48 KB."""
    g = normalize_flip_geometry(n, h, w, out_dtype)
    out_bytes = torch.finfo(out_dtype).bits // 8
    row_len = 3 * w
    assert g.vec * out_bytes == 16
    assert g.tiles * g.rows + g.tail == n * h and g.tail >= 0
    assert 1 <= g.grid <= max(1, min(g.tiles + g.tail, preprocess.SMS * preprocess.BLOCKS_PER_SM))
    if g.rows == 0:
        assert g.tiles == 0 and g.smem == 0
        assert min(r for r in range(1, 17) if r * row_len % 16 == 0) * row_len > preprocess.MAX_TILE
        return
    tile = g.rows * row_len
    assert tile % 16 == 0 and tile * out_bytes % 16 == 0
    base = min(r for r in range(1, 17) if r * row_len % 16 == 0)
    assert g.rows % base == 0
    assert tile <= preprocess.MAX_TILE
    assert g.rows == base or (g.rows - base) * row_len < preprocess.TILE_TARGET
    assert g.tail < g.rows or g.tiles == 0
    assert g.smem == (2 * tile + g.rows if g.tiles else 0) and g.smem <= 48 * 1024


def test_normalize_flip_geometry_at_the_main_path():
    """The serving and training batches at 380²: tiles of 8 rows (9,120
    bytes in), no scalar rows; at 256² tiles of 11 rows (8,448 bytes) and
    8 or 5 scalar rows."""
    for n, tail in ((20, 5), (32, 8)):
        for dt in DTYPES:
            g = normalize_flip_geometry(n, 380, 380, dt)
            assert (g.rows, g.tiles, g.tail, g.grid) == (8, n * 380 // 8, 0, {20: 950, 32: 1056}[n])
            g = normalize_flip_geometry(n, 256, 256, dt)
            assert (g.rows, g.tiles, g.tail) == (11, n * 256 // 11, tail)


def _emulate(x: np.ndarray, flip, out_dtype, aligned: bool) -> torch.Tensor:
    """The kernel's work on the host: for every output element the input
    byte and channel it normalises, found as the kernel finds them. Each
    output element must be written exactly once."""
    n, h, w, _ = x.shape
    g = normalize_flip_geometry(n, h, w, out_dtype)
    row_len, nh = 3 * w, n * h
    out_bytes = torch.finfo(out_dtype).bits // 8
    flips = np.zeros(n, bool) if flip is None else flip.astype(bool)
    src = np.full(nh * row_len, -1, np.int64)
    chan = np.full(nh * row_len, -1, np.int64)
    writes = np.zeros(nh * row_len, np.int64)
    tiles = g.tiles if aligned else 0
    if tiles:
        tb, vec = g.rows * row_len, g.vec
        t = np.arange(tiles)[:, None]
        assert tb % 16 == 0  # the tile's cp.async copies are whole 16-byte chunks
        flags = flips[(t * g.rows + np.arange(g.rows)[None, :]) // h]  # (tiles, R)
        e0 = np.arange(0, tb, vec)  # a thread's vector starts in the tile
        assert ((e0 * out_bytes) % 16 == 0).all() and (tb * out_bytes) % 16 == 0
        r = e0 // row_len
        pos = e0 - r * row_len
        ch = [pos % 3]  # the channels value j cycles through: ch[j % 3]
        for _ in range(2):
            ch.append(np.where(ch[-1] == 2, 0, ch[-1] + 1))
        # a vector inside one unflipped row loads tile[e0, e0 + vec) at once
        fast = ~flags[:, r] & (pos + vec <= row_len)
        for j in range(vec):
            wrap = pos == row_len
            pos, r = np.where(wrap, 0, pos), r + wrap
            assert r.max() < g.rows  # a vector never runs past its tile
            flipped = flags[:, r]  # (tiles, vectors)
            c = ch[j % 3]
            k = np.where(flipped, row_len - 3 - pos + 2 * c, pos)
            out_at = (t * tb + e0 + j).ravel()
            src[out_at] = (t * tb + np.where(fast, e0 + j, r * row_len + k)).ravel()
            chan[out_at] = np.broadcast_to(c, flipped.shape).ravel()
            np.add.at(writes, out_at, 1)
            pos = pos + 1
    rows = np.arange(tiles * g.rows, nh)[:, None]
    pos = np.arange(row_len)[None, :]
    c = pos % 3
    k = np.where(flips[rows // h], row_len - 3 - pos + 2 * c, pos)
    out_at = (rows * row_len + pos).ravel()
    src[out_at] = (rows * row_len + k).ravel()
    chan[out_at] = np.broadcast_to(c, k.shape).ravel()
    np.add.at(writes, out_at, 1)
    assert (writes == 1).all()
    m = np.asarray(MEAN, np.float32)
    inv = (1.0 / torch.tensor(STD, dtype=torch.float32)).numpy()
    v = x.reshape(-1)[src].astype(np.float32)
    y = (v * np.float32(1.0 / 255.0) - m[chan]) * inv[chan]
    return torch.from_numpy(y.reshape(x.shape)).to(out_dtype)


# (N, H, W) for the emulation: the main path's widths with H cut to 7 (the
# tiles depend on W and N*H: every batch but 380² at n = 32 leaves scalar
# rows), then the edge shapes
EMULATED = [(n, 7, s) for s in (380, 256) for n in (1, 20, 32)] + [
    (3, 7, 13), (4, 5, 1), (1, 1, 1), (2, 3, 7), (1, 3, 427), (1, 3, 2000)]


def _flip(pattern: str, n: int):
    if pattern == "none":
        return None
    if pattern == "all":
        return np.ones(n, bool)
    return np.arange(n) % 3 != 1  # flipped, kept, flipped, flipped, kept, ...


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("pattern", ["none", "all", "mixed"])
@pytest.mark.parametrize("out_dtype", DTYPES, ids=_dt_ids)
@pytest.mark.parametrize("n,h,w", EMULATED, ids=lambda v: str(v))
def test_emulated_kernel_equals_plain(n, h, w, out_dtype, pattern, aligned):
    x = np.random.default_rng(n * 1000 + h * 10 + w).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    flip = _flip(pattern, n)
    got = _emulate(x, flip, out_dtype, aligned)
    ref = normalize_flip_plain(torch.from_numpy(x), None if flip is None else torch.from_numpy(flip),
                               MEAN, STD, out_dtype)
    assert got.dtype == ref.dtype == out_dtype
    assert torch.equal(got, ref)


def test_wrapper_passes_the_geometry_a_uint8_view_and_cached_params(monkeypatch):
    """The arguments the card would get, with the build and the stream
    stubbed: the geometry's R, tiles and grid, the aligned flag of the
    batch's pointer, the bool mask as a uint8 view of the same memory (no
    cast), and one host array per (mean, std), reused."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "uses_kernel", lambda t: True)
    monkeypatch.setattr(_build, "function", lambda *a: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    storage = torch.zeros(2 * 7 * 13 * 3 + 1, dtype=torch.uint8)
    mask = torch.tensor([True, False])
    before = preprocess.normalize_flip.launches
    for offset in (0, 1):
        x = storage[offset:offset + 2 * 7 * 13 * 3].view(2, 7, 13, 3)
        preprocess.normalize_flip(x, mask, MEAN, STD, torch.bfloat16)
    assert preprocess.normalize_flip.launches == before + 2
    g = normalize_flip_geometry(2, 7, 13, torch.bfloat16)
    for (xp, fp, _, _, *ints, _), offset in zip(calls, (0, 1)):
        assert xp == storage.data_ptr() + offset and fp == mask.data_ptr()
        assert ints == [2, 7, 13, 1, g.rows, g.tiles, g.grid,
                        int((storage.data_ptr() + offset) % 16 == 0)]
    assert calls[0][3] == calls[1][3] == ctypes.addressof(preprocess._kernel_params(MEAN, STD))
