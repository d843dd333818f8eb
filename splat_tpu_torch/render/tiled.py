"""Tiled renderer: the production path.

projection front end (front.py: the projection and each gaussian's
binning inputs, one kernel) -> tile binning (binning.py, kernel K1) ->
per-tile compositing (kernels.py, kernel K2).  Port of
``splat_tpu/render/tiled.py``.
"""

from __future__ import annotations

import torch

from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.device import filled
from splat_tpu_torch.render.binning import bin_front
from splat_tpu_torch.render.front import project_front
from splat_tpu_torch.render.kernels import rasterize_tiles
from splat_tpu_torch.utils.image import box_downsample


class CapacityOverflow(RuntimeError):
    """Pairs were dropped because the duplication buffer was too small."""


def render_tiled(scene, camera, config: RenderConfig | None = None, *,
                 return_stats: bool = False):
    """Render a ``GaussianScene`` or a ``DeviceScene`` (the same image
    bit for bit; a frame loop packs once, ``scene.pack_device()``) to
    float32 (H, W, 3) — or (H, W, 4) RGBA with config.alpha_channel — on
    the scene's device.

    return_stats: also return a dict of device scalars: num_pairs,
      overflow, visible, max_tile_pairs, mean_tile_pairs.  Nothing here
      waits for the device.
    """
    config = config or RenderConfig()
    ss = config.supersample
    if ss > 1:
        camera = camera.scaled(ss)
    h, w = camera.h, camera.w
    dev = scene.device
    if scene.num_gaussians == 0:
        bgc = tuple(config.background)
        if config.alpha_channel:
            bgc = bgc + (0.0,)  # nothing rendered: zero coverage
        img = filled(bgc, dev).expand(h // ss, w // ss, len(bgc)).clone()
        if return_stats:
            z = torch.zeros((), dtype=torch.int64, device=dev)
            return img, {"num_pairs": z, "overflow": z, "visible": z,
                         "max_tile_pairs": z,
                         "mean_tile_pairs": torch.zeros((), device=dev)}
        return img
    front = project_front(scene, camera.to(dev), config)
    bins = bin_front(front, h, w, config)
    img = box_downsample(rasterize_tiles(bins, h, w, config), ss)
    if return_stats:
        occupancy = bins.tile_end - bins.tile_start
        return img, {
            "num_pairs": bins.num_pairs,
            "overflow": bins.overflow,
            "visible": front.num_visible,
            "max_tile_pairs": occupancy.max(),
            "mean_tile_pairs": occupancy.to(torch.float32).mean(),
        }
    return img


def render_tiled_checked(scene, camera, config: RenderConfig | None = None):
    """render_tiled that raises on duplication-buffer overflow (one host
    sync): capacity-bounded binning must never truncate silently."""
    img, stats = render_tiled(scene, camera, config, return_stats=True)
    raise_on_overflow(stats)
    return img


def raise_on_overflow(stats) -> None:
    """Raise CapacityOverflow where ``render_tiled``'s stats report
    dropped pairs (one host read)."""
    overflow = int(stats["overflow"])
    if overflow > 0:
        raise CapacityOverflow(
            f"tile duplication buffer overflow: {overflow} pairs dropped "
            f"(num_pairs={int(stats['num_pairs'])}); raise "
            f"RenderConfig.max_dup_factor")
