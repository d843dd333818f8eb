"""Build and load the port's CUDA kernels (counterpart of
``splat_tpu/native/build.py``).

``csrc/*.cu`` (with the headers ``csrc/*.cuh`` they include) are compiled
with ``nvcc`` for Hopper (``sm_90a``), one process per source, all started
together, and linked into one shared
library with a plain C interface, at first use, under
``build/kernels/`` at the root of the checkout.  The file name carries a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the library.  It is loaded with ``ctypes``: every pointer and the
stream are ``c_void_p``, and each entry point returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C entry points and their argument types (see csrc/*.cu)
_SIGNATURES = {
    "splat_expand_pairs": [_P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I,
                           _I, _P, _P, _P],
    "splat_rasterize": [_P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I,
                        _I, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
    "splat_rasterize_train_fwd": [_P, _P, _P, _P, _P, _L, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _I, _I, _F, _F, _I, _F, _I,
                                  _I, _I, _I, _I, _I, _P],
    "splat_rasterize_train_bwd": [_P, _P, _P, _P, _P, _P, _P, _L, _P, _P,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _F, _I, _I, _I, _I, _I, _I, _P],
    "splat_strip_reaches": [_P, _P, _P, _I, _P],
    "splat_project_front": [_P, _L, _L, _P, _F, _F, _F, _F, _F, _F, _I, _I,
                            _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the headers too: an edited header must not reuse a stale library
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsplat_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless the library for them already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    failed = []
    for cmd, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{err}")
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.splat_error_string.argtypes = [ctypes.c_int]
        lib.splat_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel may be handed."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().splat_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
