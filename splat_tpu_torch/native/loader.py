"""The native PLY loader's entry point."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from splat_tpu_torch.native.build import load_library
from splat_tpu_torch.scene import GaussianScene


class NativeUnsupported(RuntimeError):
    """The file is not the standard schema the native loader reads
    (binary little-endian, every vertex property float32)."""


def load_ply_native(path: str | os.PathLike, *, center: bool = True,
                    num_threads: int = 0, device=None) -> GaussianScene:
    """Load a standard-schema 3DGS PLY through the C++ loader: one pass over
    the payload per thread, activations applied on the way, into NumPy
    buffers that then move to ``device`` (None = cuda:0).

    Raises NativeUnsupported for any other schema (the caller falls back
    to the NumPy reader), RuntimeError when the library cannot be built.
    """
    lib = load_library()
    pathb = os.fspath(path).encode()
    sh_rest = ctypes.c_int(0)
    n = lib.splat_ply_query(pathb, ctypes.byref(sh_rest))
    if n < 0:
        raise NativeUnsupported(lib.splat_ply_last_error().decode())
    n = int(n)
    coeffs = 1 + sh_rest.value

    means = np.empty((n, 3), np.float32)
    quats = np.empty((n, 4), np.float32)
    scales = np.empty((n, 3), np.float32)
    opac = np.empty((n,), np.float32)
    sh = np.empty((n, coeffs, 3), np.float32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    rc = lib.splat_ply_read(pathb, fp(means), fp(quats), fp(scales),
                            fp(opac), fp(sh), num_threads)
    if rc != 0:
        raise NativeUnsupported(lib.splat_ply_last_error().decode())
    if center and n > 0:          # the mean of an empty slice is NaN
        means -= means.mean(axis=0, keepdims=True)
    return GaussianScene.create(means=means, quats=quats, scales=scales,
                                opacities=opac, sh=sh, device=device)
