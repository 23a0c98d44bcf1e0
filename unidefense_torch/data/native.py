"""ctypes binding of the host JPEG library (``csrc/host_jpeg.cc``;
unidefense_tpu/data/native.py:21-122).

``decode_batch(blobs, boxes, out_h, out_w, interp)`` decodes a whole batch
of JPEG and PNG frames on a pool of threads, crop and resize (bilinear, or
bicubic as cv2's INTER_CUBIC) included, into one contiguous uint8 NHWC
array; ``jpeg_dims(blobs)`` reads the frames' sizes from their headers;
``encode_jpeg(frame, quality)`` is the counterpart of
``cv2.imencode('.jpg', ...)``. The library is built with
``g++`` at first use (``ops/_build.host_library``) against libjpeg where its
header is found, else against nvJPEG; it decodes PNG frames (Celeb-DF's) on
the host with code of its own on both builds, to the pixels
``cv2.imdecode(..., IMREAD_COLOR)`` gives. There is no cv2 fallback: a frame
of another format raises.
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
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ud_jpeg_dims.restype = ctypes.c_int
    lib.ud_jpeg_dims.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
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


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _is_jpeg(blob: bytes) -> bool:
    return len(blob) > 2 and blob[0] == 0xFF and blob[1] == 0xD8


def _check_format(blobs: Sequence[bytes]) -> None:
    if not all(_is_jpeg(b) or b[:8] == PNG_SIGNATURE for b in blobs):
        raise NotImplementedError("the port decodes JPEG and PNG frames only")


INTER_LINEAR, INTER_CUBIC = 1, 2  # cv2's codes of the two resizes, as the YAMLs give them


def decode_batch(blobs: Sequence[bytes], boxes: Optional[np.ndarray], out_h: int, out_w: int,
                 n_threads: int = 0, interp: int = INTER_LINEAR) -> np.ndarray:
    """Decode JPEG and PNG frames, mixed as they come, to (N, out_h, out_w,
    3) RGB uint8.

    boxes: int32 (N, 4) [x1, y1, x2, y2] crop rectangles (x2 <= x1 = no
    crop), or None. interp: cv2's code of the resize, 1 (bilinear) or 2
    (bicubic). Raises NotImplementedError for a frame that is neither JPEG
    nor PNG or another interp, and IOError for a frame that does not decode
    (a damaged stream). Interlaced (Adam7) PNGs decode."""
    if interp not in (INTER_LINEAR, INTER_CUBIC):
        raise NotImplementedError(f"interpolation {interp}: the host library resizes with 1 "
                                  "(bilinear) or 2 (bicubic)")
    n = len(blobs)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    if n == 0:
        return out
    _check_format(blobs)
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
                             _device(), int(interp))
    if ok != n:
        raise IOError(f"{backend()} decoded {ok} of {n} frames")
    return out


def jpeg_dims(blobs: Sequence[bytes]) -> np.ndarray:
    """(N, 2) int32 (height, width) of JPEG and PNG frames, read from their
    headers without decoding. Raises IOError for a header that does not
    parse."""
    n = len(blobs)
    dims = np.zeros((n, 2), np.int32)
    if n == 0:
        return dims
    _check_format(blobs)
    ok = get_lib().ud_jpeg_dims((ctypes.c_char_p * n)(*blobs),
                                (ctypes.c_size_t * n)(*[len(b) for b in blobs]), n,
                                dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _device())
    if ok != n:
        raise IOError(f"{backend()} read {ok} of {n} frame headers")
    return dims


def encode_jpeg(frame: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) RGB uint8 -> baseline JPEG bytes, 4:2:0 chroma, like
    ``cv2.imencode('.jpg', bgr, [IMWRITE_JPEG_QUALITY, quality])``: its bytes
    on the libjpeg build; on nvJPEG the same planes and quantisation tables
    through nvJPEG's forward DCT."""
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
