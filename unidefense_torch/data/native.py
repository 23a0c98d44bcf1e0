"""ctypes binding of the host JPEG library (``csrc/host_jpeg.cc``;
unidefense_tpu/data/native.py:21-122).

``decode_batch(blobs, boxes, out_h, out_w)`` decodes a whole batch of JPEG
frames on a pool of threads, crop and bilinear resize included, into one
contiguous uint8 NHWC array; ``encode_jpeg(frame, quality)`` is the
counterpart of ``cv2.imencode('.jpg', ...)``. The library is built with
``g++`` at first use (``ops/_build.host_library``) against libjpeg where its
header is found, else against nvJPEG. There is no cv2 fallback: a frame that
is not a JPEG raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from unidefense_torch.ops import _build


@functools.lru_cache(maxsize=1)
def get_lib() -> ctypes.CDLL:
    lib = _build.host_library()
    lib.ud_jpeg_backend.restype = ctypes.c_char_p
    lib.ud_jpeg_backend.argtypes = []
    lib.ud_decode_batch.restype = ctypes.c_int
    lib.ud_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
    ]
    lib.ud_encode_jpeg.restype = ctypes.c_long
    lib.ud_encode_jpeg.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_int,
    ]
    return lib


def backend() -> str:
    """'libjpeg' or 'nvjpeg': the library the decoder was built against."""
    return get_lib().ud_jpeg_backend().decode()


def _device() -> int:
    # the nvJPEG backend decodes on the current card; libjpeg ignores it
    return torch.cuda.current_device() if torch.cuda.is_available() else 0


def _is_jpeg(blob: bytes) -> bool:
    return len(blob) > 2 and blob[0] == 0xFF and blob[1] == 0xD8


def decode_batch(blobs: Sequence[bytes], boxes: Optional[np.ndarray], out_h: int, out_w: int,
                 n_threads: int = 0) -> np.ndarray:
    """Decode JPEG frames to (N, out_h, out_w, 3) RGB uint8.

    boxes: int32 (N, 4) [x1, y1, x2, y2] crop rectangles (x2 <= x1 = no
    crop), or None. Raises NotImplementedError for a frame that is not a
    JPEG and IOError for one that does not decode."""
    n = len(blobs)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    if n == 0:
        return out
    if not all(_is_jpeg(b) for b in blobs):
        raise NotImplementedError("the port decodes JPEG frames only; other formats (the PNG "
                                  "frames of Celeb-DF) are ROADMAP.md queue 3")
    lib = get_lib()
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, n)
    blob_ptrs = (ctypes.c_char_p * n)(*blobs)
    sizes = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    boxes_ptr = None
    if boxes is not None:
        boxes_arr = np.ascontiguousarray(boxes, np.int32)
        boxes_ptr = boxes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    ok = lib.ud_decode_batch(blob_ptrs, sizes, n, boxes_ptr, out_h, out_w,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads,
                             _device())
    if ok != n:
        raise IOError(f"{backend()} decoded {ok} of {n} JPEG frames")
    return out


def encode_jpeg(frame: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) RGB uint8 -> baseline JPEG bytes, 4:2:0 chroma, like
    ``cv2.imencode('.jpg', bgr, [IMWRITE_JPEG_QUALITY, quality])``."""
    frame = np.ascontiguousarray(frame, np.uint8)
    h, w, c = frame.shape
    if c != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) frames, got {frame.shape}")
    lib = get_lib()
    cap = 2 * frame.nbytes + 65536
    for _ in range(2):
        buf = np.empty(cap, np.uint8)
        n = lib.ud_encode_jpeg(frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                               int(quality), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               cap, _device())
        if n > 0:
            return buf[:n].tobytes()
        if n == 0:
            break
        cap = -n
    raise IOError(f"{backend()} failed to encode a {h}x{w} frame")
