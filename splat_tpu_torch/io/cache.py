"""NPZ cache of a scene's activated arrays.

Parsing and activating a multi-GB PLY dominates start-up; the cache keeps
the arrays after activation, so a warm start is one read.  The version and
the keys are ``splat_tpu.io.cache``'s, so a cache written by either package
loads in the other.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from splat_tpu_torch.scene import GaussianScene

_CACHE_VERSION = 1


def save_npz(path: str | os.PathLike, scene: GaussianScene) -> None:
    np.savez(path, _version=_CACHE_VERSION, **scene.to_numpy())


def load_npz(path: str | os.PathLike, device=None) -> GaussianScene:
    """A scene from a cache written by :func:`save_npz` (either package's),
    on ``device`` (None = cuda:0)."""
    with np.load(path) as z:
        if int(z.get("_version", 0)) != _CACHE_VERSION:
            raise ValueError(f"cache version mismatch in {path}")
        return GaussianScene.create(
            means=z["means"], quats=z["quats"], scales=z["scales"],
            opacities=z["opacities"], sh=z["sh"], device=device)


def load_scene_cached(ply_path: str | os.PathLike, *, center: bool = True,
                      device=None) -> GaussianScene:
    """Load a scene through a sibling ``<name>.ply.npz`` cache, written on
    the first load.  As in ``splat_tpu``, the cache does not record
    ``center``: a warm start returns the arrays the first load stored."""
    from splat_tpu_torch.io.ply import load_ply

    cache = os.fspath(ply_path) + ".npz"
    if os.path.exists(cache) and (
            os.path.getmtime(cache) >= os.path.getmtime(ply_path)):
        try:
            return load_npz(cache, device=device)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass          # stale or corrupt cache: rebuild it
    scene = load_ply(ply_path, center=center, device=device)
    try:
        save_npz(cache, scene)
    except OSError:
        pass              # read-only location: the cache is best-effort
    return scene
