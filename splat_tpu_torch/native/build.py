"""Build and load the native PLY loader (``ply_loader.cpp``).

At first use ``g++`` compiles the source into ``build/native/`` at the root
of the checkout (gitignored), under a name that carries a hash of the
source, the flags and the CPU (``-march=native`` compiles for this one), so
an edit or another machine rebuilds and an unchanged tree reuses the
library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent
SRC = _PKG / "ply_loader.cpp"
BUILD_DIR = _PKG.parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None


def _cpu_id() -> str:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            return "".join([line for line in f if line.startswith(
                ("model name", "flags"))][:2])
    except OSError:
        return platform.machine()


def library_path() -> pathlib.Path:
    """Where the library for the current source and CPU lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_id().encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"ply_loader_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``ply_loader.cpp`` unless its library already exists.
    Raises RuntimeError when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native PLY loader: cannot run g++ ({e}); set "
                           f"SPLAT_TPU_NO_NATIVE=1 to load with NumPy") from e
    if res.returncode != 0:
        raise RuntimeError(f"native PLY loader: g++ failed "
                           f"({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.splat_ply_query.restype = ctypes.c_longlong
            lib.splat_ply_query.argtypes = [ctypes.c_char_p,
                                            ctypes.POINTER(ctypes.c_int)]
            lib.splat_ply_last_error.restype = ctypes.c_char_p
            lib.splat_ply_last_error.argtypes = []
            lib.splat_ply_read.restype = ctypes.c_int
            lib.splat_ply_read.argtypes = (
                [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_float)] * 5
                + [ctypes.c_int])
            _lib = lib
        return _lib
