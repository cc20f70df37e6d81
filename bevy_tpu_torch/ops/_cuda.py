"""Build and bind the hand-written CUDA kernels of `bevy_tpu_torch/csrc/`.

Each source compiles with its own nvcc process (all started together),
and the objects link into one shared library with a plain C interface,
loaded with ctypes. The build runs at the first CUDA launch
(never at import) into `bevy_tpu_torch/_build/<hash of the sources>/`, so
a fresh checkout builds everything on its first frame and later processes
reuse the library. Each C entry point takes device pointers and the CUDA
stream as integers, launches on that stream without synchronising, and
returns `cudaGetLastError()`; `check()` raises on a non-zero code. A
wrapper takes its call's one device from `call_device()` and launches
under `torch.cuda.device()` of it, so a kernel runs on the card that holds
its tensors, not on whichever card is current.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("splat_raster.cu", "stream_raster.cu", "deferred_shade.cu",
           "sprite_tiles.cu", "sprite_splat.cu", "window_composite.cu",
           "tri_raster.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bt_splat_fused": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P],
    "bt_stream_raster": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _I, _P, _P, _P],
    "bt_deferred_shade": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I,
                          _I, _I, _I, _P, _P],
    "bt_sprite_tiles": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P, _P],
    "bt_sprite_splat": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _P, _P],
    "bt_window_composite": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                            _P, _P, _P],
    "bt_tri_raster": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P, _P, _P],
}


class _Loaded:
    lib = None
    build_seconds = None
    ptxas_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of bevy_tpu_torch cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256()
    for path in [CSRC / name for name in SOURCES] + sorted(
            CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def library():
    """The loaded kernel library, building it first if needed."""
    if _Loaded.lib is not None:
        return _Loaded.lib
    out_dir = build_dir()
    so = out_dir / "libbevy_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        tmp = out_dir / f"libbevy_kernels.{tag}.so"
        objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(SOURCES, objs)]
            logs = [p.communicate()[0] for p in procs]
            for s, p, log in zip(SOURCES, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {s} "
                                       f"({p.returncode}):\n{log}")
            res = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                  *map(str, objs)], capture_output=True,
                                 text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            os.replace(tmp, so)
        finally:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
        _Loaded.build_seconds = time.perf_counter() - t0
        _Loaded.ptxas_log = "".join(logs)
        (out_dir / "ptxas.log").write_text(_Loaded.ptxas_log)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bt_error_string.argtypes = [ctypes.c_int]
    lib.bt_error_string.restype = ctypes.c_char_p
    _Loaded.lib = lib
    return lib


INVALID_VALUE = 1  # cudaErrorInvalidValue: a shape the C side refuses


def check(err: int, name: str):
    if err != 0:
        msg = library().bt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def call_device(*tensors) -> torch.device:
    """The one device of a kernel call's tensors (None entries skipped).
    Raises when they sit on different devices: a launch runs on one card,
    and a pointer into another card's memory would fault there or read
    the wrong buffer."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"a kernel call's tensors sit on different devices: "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, where given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
