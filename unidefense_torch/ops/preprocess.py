"""K1: fused uint8 -> normalised float preprocessing with per-sample flip
(unidefense_tpu/ops/pallas_preprocess.py:29-77).

``normalize_flip`` launches ``csrc/normalize_flip.cu`` for a CUDA batch and
runs :func:`normalize_flip_plain` for a CPU batch. Both use the TPU kernel's
formula ``(u8 * (1/255) - mean) * inv_std`` with ``inv_std = 1/std`` in fp32,
rounded after each step. The kernel's tiles come from
:func:`normalize_flip_geometry`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch

from unidefense_torch.ops import _build

SMS = 132  # streaming multiprocessors of an H100
BLOCKS_PER_SM = 8  # K1 blocks of the grid per SM, chosen by timing on the card; 5-6 fit at once
TILE_TARGET = 8192  # input bytes a tile is rounded up towards
MAX_TILE = 20480  # input bytes of a tile at most: two tiles and their flags stay under 48 KB


@dataclasses.dataclass(frozen=True)
class NormalizeFlipGeometry:
    """Launch geometry of K1 (``csrc/normalize_flip.cu``, 256 threads) for an
    (n, h, w, 3) batch. The flattened (n, h) rows form ``tiles`` tiles of
    ``rows`` rows, each a whole number of 16-byte vectors in and out, then
    ``tail`` rows that take the kernel's scalar path; ``rows`` is 0 where no
    such tile fits the shared memory, and then every row is scalar."""

    rows: int  # R, image rows per tile
    tiles: int  # full tiles, floor(N*H / R)
    tail: int  # rows after the last full tile
    vec: int  # output values per 16-byte store: 4 fp32 or 8 bf16
    smem: int  # dynamic shared memory bytes: a ring of two tiles and R flip bits
    grid: int  # blocks, walking the tiles and tail rows in a grid-stride loop


@functools.lru_cache(maxsize=256)
def normalize_flip_geometry(n: int, h: int, w: int, out_dtype: torch.dtype) -> NormalizeFlipGeometry:
    """K1's tiles for an (n, h, w, 3) uint8 batch into ``out_dtype``: R is the
    smallest row count whose 3WR input bytes and 3WR * out bytes are
    multiples of 16, times the smallest factor that brings the tile to 8 KB,
    as far as the batch's N*H rows and 20 KB allow; eight blocks per SM."""
    out_bytes = torch.finfo(out_dtype).bits // 8
    row_len = 3 * w
    base = 16 // math.gcd(row_len, 16)  # 16-byte input; the 2- or 4-byte output follows
    if base * row_len > MAX_TILE:
        rows = 0
    else:
        k = min(-(-TILE_TARGET // (base * row_len)), MAX_TILE // (base * row_len), (n * h) // base)
        rows = base * max(1, k)
    tiles = (n * h) // rows if rows else 0
    tail = n * h - tiles * rows
    return NormalizeFlipGeometry(
        rows=rows, tiles=tiles, tail=tail, vec=16 // out_bytes,
        smem=2 * rows * row_len + rows if tiles else 0,
        grid=max(1, min(tiles + tail, SMS * BLOCKS_PER_SM)))


def _mean_inv_std(mean: Sequence[float], std: Sequence[float]) -> tuple[torch.Tensor, torch.Tensor]:
    m = torch.tensor(mean, dtype=torch.float32)
    inv = 1.0 / torch.tensor(std, dtype=torch.float32)
    return m, inv


@functools.lru_cache(maxsize=64)  # one per (mean, std); never written after it is built
def _kernel_params(mean: tuple, std: tuple) -> ctypes.Array:
    """The kernel's host array (mean[0..2], inv_std[0..2]), the same fp32
    values the plain version computes."""
    m, inv = _mean_inv_std(mean, std)
    return (ctypes.c_float * 6)(*m.tolist(), *inv.tolist())


def _check(batch_u8: torch.Tensor, flip_mask: Optional[torch.Tensor], out_dtype) -> None:
    if batch_u8.dtype != torch.uint8 or batch_u8.dim() != 4 or batch_u8.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) uint8, got {tuple(batch_u8.shape)} {batch_u8.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if flip_mask is not None:
        if flip_mask.shape != (batch_u8.shape[0],) or flip_mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError("flip_mask must be a (N,) bool or uint8 tensor")
        if flip_mask.device != batch_u8.device:
            raise ValueError("flip_mask must lie on the batch's device")


def normalize_flip_plain(batch_u8: torch.Tensor, flip_mask: Optional[torch.Tensor] = None,
                         mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K1 (same formula, flip as a reversed view)."""
    _check(batch_u8, flip_mask, out_dtype)
    m, inv = (t.to(batch_u8.device) for t in _mean_inv_std(mean, std))
    x = batch_u8
    if flip_mask is not None:
        x = torch.where(flip_mask.bool().view(-1, 1, 1, 1), x.flip(2), x)
    y = (x.float() * (1.0 / 255.0) - m) * inv
    return y.to(out_dtype)


def normalize_flip(batch_u8: torch.Tensor, flip_mask: Optional[torch.Tensor] = None,
                   mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                   out_dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, H, W, 3) ``out_dtype``, sample n mirrored
    along W where ``flip_mask[n]``. CUDA tensors launch the kernel."""
    if not _build.uses_kernel(batch_u8):
        return normalize_flip_plain(batch_u8, flip_mask, mean, std, out_dtype)
    _check(batch_u8, flip_mask, out_dtype)
    if not batch_u8.is_contiguous():
        raise ValueError("batch_u8 must be contiguous NHWC")
    n, h, w, _ = batch_u8.shape
    geo = normalize_flip_geometry(n, h, w, out_dtype)
    fn = _build.function("normalize_flip", "ud_normalize_flip", 4, 8)
    out = torch.empty(batch_u8.shape, dtype=out_dtype, device=batch_u8.device)
    flip = None if flip_mask is None else flip_mask.view(torch.uint8).contiguous()
    params = _kernel_params(tuple(mean), tuple(std))
    err = fn(batch_u8.data_ptr(), None if flip is None else flip.data_ptr(), out.data_ptr(),
             ctypes.addressof(params), n, h, w, int(out_dtype == torch.bfloat16), geo.rows,
             geo.tiles, geo.grid, int(batch_u8.data_ptr() % 16 == 0), _build.stream_ptr(batch_u8))
    _build.check(err, "normalize_flip")
    normalize_flip.launches += 1
    return out


normalize_flip.launches = 0  # kernel launches since the last reset
