"""Public render API: ``render(scene, camera, config) -> image``.

Port of ``splat_tpu/render/api.py``.  As there, one compiled function from
camera pose to image; only the pose is a per-frame input.  On the card
``render_fn`` and ``render()`` replay a frame captured into a CUDA graph
(``render/graph.py``, the port's ``jax.jit``): one capture per method,
config, scene, resolution and camera kind.  On CPU tensors they run the
eager frame.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref

import torch

from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.render.binning import count_pairs
from splat_tpu_torch.render import graph
from splat_tpu_torch.render.dense import render_dense
from splat_tpu_torch.render.tiled import (CapacityOverflow, raise_on_overflow,
                                         render_tiled)
from splat_tpu_torch.scene import GaussianScene


def resolve_method(method: str, scene) -> str:
    """'auto' -> 'dense' for tiny scenes, 'tiled' otherwise."""
    if method == "auto":
        return "dense" if scene.num_gaussians <= 4096 else "tiled"
    return method


def frame_fn(method: str, config: RenderConfig, *,
             return_stats: bool = False):
    """The compiled frame ``f(scene, camera)`` of ``render_tiled``
    (``return_stats`` as there) or ``render_dense`` at ``config``: on the
    card a replay of its captured graph, on CPU tensors the eager call."""
    if method == "tiled":
        fn = functools.partial(render_tiled, config=config,
                               return_stats=return_stats)
    elif method == "dense" and not return_stats:
        fn = functools.partial(render_dense, config=config)
    else:
        raise ValueError(f"no compiled frame for method {method!r}"
                         + (" with stats" if return_stats else ""))
    return graph.compiled(fn, (method, config, return_stats))


def render_fn(method: str = "auto", config: RenderConfig | None = None):
    """Return the compiled ``f(scene, camera) -> float32 (H, W, 3)``
    ((H, W, 4) with config.alpha_channel) for a ``GaussianScene`` or a
    ``DeviceScene``, which ``f`` renders as given: on the card it replays
    a captured frame (:func:`frame_fn`).  method: 'dense', 'tiled' or
    'auto'."""
    config = config or RenderConfig()

    def f(scene, camera):
        m = resolve_method(method, scene)
        if m not in ("dense", "tiled"):
            raise ValueError(f"unknown render method {method!r}")
        return frame_fn(m, config)(scene, camera)

    return f


def _render_checked(scene, camera, config: RenderConfig):
    """The compiled tiled frame; its overflow is read once after the
    frame (one host sync) and raises."""
    img, stats = frame_fn("tiled", config, return_stats=True)(scene, camera)
    raise_on_overflow(stats)
    return img


def pair_stats(scene, camera, config: RenderConfig | None = None) -> dict:
    """The scene's true (gaussian, tile) pair load at a pose.

    Returns ``visible``, ``num_pairs``, ``pairs_per_gaussian``, ``slots``
    and ``suggested_dup_factor`` (slots/N + 25%, at least 1.25).  On the
    card the slot demand is the pair count alone; the TPU package's depth
    mode also spends one slot per invisible gaussian, so ``slots`` (and
    the capacity derived from it) differ between the packages by design.
    """
    config = config or RenderConfig()
    if config.supersample > 1:
        camera = camera.scaled(config.supersample)
    proj = project_gaussians(scene, camera.to(scene.device), config)
    visible, pairs = (int(x) for x in count_pairs(proj, camera.h, camera.w,
                                                  config))
    n = scene.num_gaussians
    return {
        "visible": visible,
        "num_pairs": pairs,
        "pairs_per_gaussian": pairs / max(n, 1),
        "slots": pairs,
        "suggested_dup_factor": max(1.25, round(pairs / max(n, 1) * 1.25,
                                                2)),
    }


def auto_config(scene, camera, config: RenderConfig | None = None, *,
                headroom: float = 1.1, quantum: float = 0.25) -> RenderConfig:
    """Size ``max_dup_factor`` from the pair load measured at this pose:
    slots/N * headroom, rounded up to a multiple of ``quantum``."""
    config = config or RenderConfig()
    stats = pair_stats(scene, camera, config)
    n = max(scene.num_gaussians, 1)
    need = stats["slots"] / n * headroom
    dup = max(1.0, math.ceil(need / quantum) * quantum)
    return dataclasses.replace(config, max_dup_factor=dup)


# auto-sized configs keyed per scene OBJECT: id(scene) plus a weakref, so a
# recycled id can never serve a stale (possibly undersized) capacity
_AUTO_CONFIG_CACHE: dict = {}


def _remember(key, scene, config) -> None:
    if len(_AUTO_CONFIG_CACHE) > 64:
        _AUTO_CONFIG_CACHE.clear()
    _AUTO_CONFIG_CACHE[key] = (weakref.ref(scene), config)


def render(scene, camera, config: RenderConfig | None = None,
           method: str = "auto", as_uint8: bool = False,
           check_overflow: bool = True):
    """Render one frame of a ``GaussianScene`` or a ``DeviceScene``.  The
    tiled path packs a ``GaussianScene`` (``pack_device()``, memoized on
    the scene).

    With no config, the tiled path sizes its pair capacity from the
    measured load (cached per scene, resolution and config); a pose that
    outgrows the cached capacity overflows, is re-measured and retried
    once, and the new capacity is a new compiled frame.  With
    check_overflow, overflow raises: never a silent truncation.  On the
    card every frame is a replay of a captured graph (:func:`frame_fn`);
    the measuring (``auto_config``) runs eagerly, once a cache miss.
    """
    auto_capacity = config is None
    config = config or RenderConfig()
    m = resolve_method(method, scene)
    cache_key = None
    if m == "tiled" and isinstance(scene, GaussianScene):
        # the tiled frame reads the feature-major layout; the pack is
        # memoized on the scene, so the capacity cache below, keyed by
        # the packed object, hits from frame to frame
        scene = scene.pack_device()
    if m == "tiled" and auto_capacity and scene.num_gaussians > 0:
        cache_key = (id(scene), scene.num_gaussians, camera.h, camera.w,
                     config)
        hit = _AUTO_CONFIG_CACHE.get(cache_key)
        cfg = None
        if hit is not None:
            ref, cfg = hit
            if ref() is not scene:      # id recycled: stale entry
                cfg = None
        if cfg is None:
            cfg = auto_config(scene, camera, config)
            _remember(cache_key, scene, cfg)
        config = cfg
    if m == "tiled" and check_overflow:
        try:
            img = _render_checked(scene, camera, config)
        except CapacityOverflow:
            if cache_key is None:
                raise
            # stale cached capacity: re-measure at THIS pose, retry once
            _AUTO_CONFIG_CACHE.pop(cache_key, None)
            config = auto_config(scene, camera, RenderConfig())
            _remember(cache_key, scene, config)
            img = _render_checked(scene, camera, config)
    else:
        img = render_fn(m, config)(scene, camera)
    if as_uint8:
        img = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return img
