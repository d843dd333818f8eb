"""splat_tpu_torch — the PyTorch + CUDA port of ``splat_tpu`` for NVIDIA
Hopper (H100).

The inference frame and tiled training run on the card: projection,
binning and the optimiser are PyTorch tensor code, and the four TPU
kernels are CUDA C++ kernels written for ``sm_90a`` (``csrc/expand.cu``:
pair expansion, ``csrc/raster.cu``: per-tile compositing,
``csrc/raster_train.cu``: the training forward and backward), built with
``nvcc`` on first use.  The inference frame reads the feature-major
``DeviceScene`` (``scene.pack_device()``; ``render()`` packs a
``GaussianScene`` once and keeps the pack), training the
``GaussianScene``.  Constructors put tensors on ``cuda:0`` unless given
``device=``.  CPU tensors take each kernel's plain PyTorch version,
which the tests hold against the JAX package.  This package never
imports JAX.

Public API::

    import splat_tpu_torch as stt

    scene  = stt.load_ply("point_cloud.ply")         # on cuda:0
    camera = stt.Camera.create(h=1080, w=1920, position=(0., 0., 5.))
    img    = stt.render(scene, camera)              # float32 (H, W, 3)
    packed = scene.pack_device()                    # stt.DeviceScene
    img    = stt.render_tiled(packed, camera)       # a frame loop's input
    res    = stt.fit(scene, stt.orbit_trajectory(camera, 4, 0.8), targets,
                     method="tiled")                # targets (4, H, W, 3)

The command line is ``python -m splat_tpu_torch
<render|orbit|serve|trim|info|bench|fit|psnr>`` (:mod:`splat_tpu_torch.cli`).
"""

from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.scene import DeviceScene, GaussianScene
from splat_tpu_torch.camera import (Camera, SE3Camera, orbit_trajectory,
                                    stack_cameras)
from splat_tpu_torch.io.cache import load_scene_cached
from splat_tpu_torch.io.ply import PlyError, load_ply, save_ply, trim_ply
from splat_tpu_torch.render.api import (auto_config, pair_stats, render,
                                        render_fn)
from splat_tpu_torch.render.dense import render_dense
from splat_tpu_torch.render.diff import render_tiled_diff
from splat_tpu_torch.render.tiled import render_tiled, render_tiled_checked
from splat_tpu_torch.train import FitResult, RawParams, fit
from splat_tpu_torch.utils.fixtures import (naive_gaussians, random_scene,
                                            surface_scene)
from splat_tpu_torch.utils.image import psnr
from splat_tpu_torch import parallel

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "GaussianScene",
    "DeviceScene",
    "Camera",
    "SE3Camera",
    "orbit_trajectory",
    "stack_cameras",
    "PlyError",
    "load_ply",
    "load_scene_cached",
    "save_ply",
    "trim_ply",
    "auto_config",
    "pair_stats",
    "render",
    "render_fn",
    "render_dense",
    "render_tiled",
    "render_tiled_checked",
    "render_tiled_diff",
    "FitResult",
    "RawParams",
    "fit",
    "naive_gaussians",
    "random_scene",
    "surface_scene",
    "psnr",
    "parallel",
]
