"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, loaded with
``ctypes``. Libraries land in ``unidefense_torch/build/`` keyed by a hash of
the source and the flags, so a second use in the same checkout loads without
compiling. Nothing here runs at import: the CPU test machine has no ``nvcc``.

Every C entry point takes device pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` after its launch; :func:`check` raises if
that is not 0.

The host JPEG library (``csrc/host_jpeg.cc``, no device code) is built the
same way by ``g++``, see :func:`host_library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0  # wall time of the last build_all() that compiled


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    # every shared header is hashed with each source: a header edit rebuilds all
    headers = b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{h}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel source; returns stem -> CDLL."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the CUDA kernels cannot run here")
        sources = sorted(SRC_DIR.glob("*.cu"))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [(s, _target(s)) for s in sources if not _target(s).exists()]
        t0 = time.perf_counter()
        if todo:
            nvcc = _nvcc()
            procs = []
            for src, out in todo:
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                log = open(out.with_suffix(".log"), "w")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, log, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT)))
            failed = []
            for src, out, tmp, log, p in procs:
                rc = p.wait()
                log.close()
                if rc == 0:
                    os.replace(tmp, out)
                else:
                    failed.append(f"{src.name}:\n{out.with_suffix('.log').read_text()}")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            build_seconds = time.perf_counter() - t0
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(_target(src)))
        return _libs


def build_logs() -> dict[str, str]:
    """nvcc/ptxas output (registers, shared memory, spills) of each library
    compiled in this checkout."""
    return {s.stem: (_target(s).with_suffix(".log").read_text()
                     if _target(s).with_suffix(".log").exists() else "")
            for s in sorted(SRC_DIR.glob("*.cu"))}


def function(lib: str, name: str, nargs_ptr: int, nargs_int: int) -> ctypes._CFuncPtr:
    """C entry ``name`` of ``csrc/<lib>.cu`` taking ``nargs_ptr`` pointers,
    then ``nargs_int`` ints, then the stream; returns a cudaError_t."""
    fn = getattr(build_all()[lib], name)
    fn.argtypes = ([ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def uses_kernel(t: torch.Tensor) -> bool:
    """Dispatch rule shared by every kernel wrapper: a CPU tensor takes the
    plain PyTorch version, a CUDA tensor the kernel (which raises if it
    cannot launch), and any other device is refused."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")


# ------------------------------------------------------------ host library

HOST_SRC = SRC_DIR / "host_jpeg.cc"
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
_host: dict[str, ctypes.CDLL] = {}


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"


def jpeg_backend() -> tuple[str, tuple[str, ...]]:
    """(backend, g++ flags) of the host JPEG library: libjpeg where g++
    finds ``jpeglib.h``, else nvJPEG from the CUDA toolkit. Raises where
    there is neither."""
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    if probe.returncode == 0:
        return "libjpeg", ("-DUD_JPEG_LIBJPEG", "-ljpeg", "-lpthread")
    cuda = _cuda_home()
    if os.path.exists(os.path.join(cuda, "include", "nvjpeg.h")):
        lib = os.path.join(cuda, "lib64")
        return "nvjpeg", ("-DUD_JPEG_NVJPEG", f"-I{cuda}/include", f"-L{lib}",
                          f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart", "-lpthread")
    raise RuntimeError("no JPEG library to build csrc/host_jpeg.cc against: neither libjpeg's "
                       f"jpeglib.h nor {cuda}/include/nvjpeg.h was found")


def host_library() -> ctypes.CDLL:
    """Compile (if needed) and load ``csrc/host_jpeg.cc`` with ``g++``;
    keyed, like the kernels, by a hash of the source and the flags. Raises
    RuntimeError if it does not build."""
    with _lock:
        if "jpeg" in _host:
            return _host["jpeg"]
        backend, flags = jpeg_backend()
        key = HOST_SRC.read_bytes() + " ".join(HOST_FLAGS + flags).encode()
        out = BUILD_DIR / f"libhost_jpeg_{backend}_{hashlib.sha256(key).hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *HOST_FLAGS, str(HOST_SRC), "-o", str(tmp), *flags]
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"g++ failed to build {HOST_SRC.name} ({backend}):\n"
                                   f"{done.stdout}{done.stderr}")
            os.replace(tmp, out)
        _host["jpeg"] = ctypes.CDLL(str(out))
        return _host["jpeg"]
