"""The projection front end: one frame's per-gaussian binning inputs.

For each gaussian, everything the tile binning reads of it
(``binning.GaussianFront``): what ``ops/projection.py::project_gaussians``
computes, then what ``binning.front_from_proj`` derives from that (the
quantized radii with visibility in bit 30, the tile spans and pair counts,
the depth bits, the 11 rows of ``FEATURE_ROWS`` and, with ``cull_pairs``,
the cull rows).  The count-only form gives just the visible count and the
pair count, the pair demand of a view.

The card runs the hand-written kernel ``csrc/project.cu`` over the packed
(59, N) scene: one thread a gaussian, nothing N-long between the scene and
the outputs.  CPU tensors take :func:`project_front_plain`, the projection
and the binning's per-gaussian tail as PyTorch ops, which the kernel
equals bit for bit.  ``render_mode="depth"`` normalises the depth over the
whole frame (``encode_depth_color``, a min and max over every gaussian):
the kernel leaves the colour rows and the wrapper fills them after it.

Only what takes no gradient comes here: the frame (``render_tiled``) and
the pair counts (``pair_stats``, ``fit``'s demand pass and capacity
checks).  Training's projection stays ``project_gaussians`` under autograd
(``render_tiled_diff``), as do the dense renderer and the sharded renders,
whose ``ProjectedGaussians`` records are gathered and routed.
"""

from __future__ import annotations

import torch

from splat_tpu_torch import _build
from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.ops.projection import (encode_depth_color,
                                            project_gaussians)
from splat_tpu_torch.render import graph
from splat_tpu_torch.render.binning import (FEATURE_DIM, GaussianFront,
                                            _grid, count_pairs,
                                            front_from_proj)
from splat_tpu_torch.scene import PACKED_ROWS, DeviceScene

# feature rows the kernel leaves to the wrapper in depth mode (r, g, b)
_COLOR_ROWS = slice(5, 8)


def project_front_plain(scene, camera, config: RenderConfig, *,
                        count_only: bool = False):
    """Plain PyTorch version of the kernel (any device): the
    ``binning.GaussianFront`` of one frame, or with ``count_only`` a (2,)
    int64 tensor of the visible and pair counts (``count_pairs``)."""
    proj = project_gaussians(scene, camera, config)
    if count_only:
        return torch.stack(count_pairs(proj, camera.h, camera.w, config))
    return front_from_proj(proj, camera.h, camera.w, config)


def packed_scene(scene):
    """The scene as :func:`project_front` reads it, packed once for any
    number of calls: on the card a ``DeviceScene`` (or a column slice of
    one) as it is and a ``GaussianScene`` packed afresh (under a captured
    frame the copies are part of the graph, which so reads the scene's
    leaves each replay); on the CPU the scene as it is, which the plain
    version reads in either layout."""
    if isinstance(scene, DeviceScene) or scene.device.type == "cpu":
        return scene
    return scene.pack_device(scene.device)


def project_front(scene, camera, config: RenderConfig, *,
                  count_only: bool = False):
    """One frame's per-gaussian binning inputs (``binning.GaussianFront``)
    of a ``GaussianScene`` or a ``DeviceScene``; with ``count_only`` a (2,)
    int64 tensor: the visible gaussians and the pairs.  Nothing waits for
    the device.

    CUDA tensors launch ``csrc/project.cu`` (or raise); CPU tensors take
    :func:`project_front_plain`.
    """
    dev = scene.device
    if dev.type == "cpu":
        return project_front_plain(scene, camera, config,
                                   count_only=count_only)
    if dev.type != "cuda":
        raise ValueError(f"project_front: unsupported device {dev}")
    rows = packed_scene(scene).buffer
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    n = rows.shape[1]
    if rows.dtype != torch.float32 or rows.shape[0] != PACKED_ROWS:
        raise ValueError(f"project_front: scene rows {rows.dtype} "
                         f"{tuple(rows.shape)}, expected float32 "
                         f"({PACKED_ROWS}, N)")
    cam = camera.record(config.sh_stale_eye)
    _build.check_tensor(cam, "camera record", torch.float32, (20,), dev)
    h, w = camera.h, camera.w
    ntx, nty = _grid(h, w, config)
    sums = torch.empty(2, dtype=torch.int64, device=dev)
    if count_only:
        outs = (None,) * 8
    else:
        # one block: the six int32 rows, then the f32 feature rows
        block = torch.empty((6 + FEATURE_DIM, n), dtype=torch.int32,
                            device=dev)
        outs = (*block[:6], block[6:].view(torch.float32),
                torch.empty((n, 4), dtype=torch.float32, device=dev)
                if config.cull_pairs else None)
    depth_mode = config.render_mode == "depth"
    fn = _build.library().splat_project_front
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # PyTorch divides an f32 tensor by a Python number on the card as
        # a product with the reciprocal, taken in double, rounded to f32
        err = fn(rows.data_ptr(), rows.stride(0), n, cam.data_ptr(),
                 config.lowpass, config.sigma_cutoff, config.alpha_min,
                 1.0 / config.alpha_min, 1.0 / config.tile_w,
                 1.0 / config.tile_h, int(config.tight_radius),
                 int(config.cov3d_transpose),
                 -1 if depth_mode else config.sh_degree, w, h, ntx, nty,
                 int(count_only),
                 *(None if t is None else t.data_ptr() for t in outs),
                 sums.data_ptr(), stream)
    _build.check(err, "project_front")
    project_front.launches += 1
    if count_only:
        project_front.count_launches += 1
        return sums
    rbits, tx0, ty0, span_w, counts, depth_bits, feats, cull = outs
    if depth_mode:
        dn = encode_depth_color(depth_bits.view(torch.float32),
                                rbits >= 1 << 30, config)
        feats[_COLOR_ROWS] = torch.clamp(dn, 0.0, 1.0)
    return GaussianFront(rbits=rbits, tx0=tx0, ty0=ty0, span_w=span_w,
                         counts=counts, depth_bits=depth_bits,
                         features=feats, cull=cull, num_visible=sums[0])


project_front.launches = 0
# of those, the count-only launches
project_front.count_launches = 0
graph.count_replays(project_front, ("launches", "count_launches"))
