"""Multi-device rendering over ``torch.distributed`` (port of
``splat_tpu.parallel.sharding``).

Two axes of a ``(d, g)`` device mesh, as in ``splat_tpu``:

* **gaussian (tensor) parallelism, axis "g"**: each rank projects its own
  contiguous shard of the gaussians; the compact projected records (13
  floats each) are all-gathered, or routed to the row slabs they touch by
  one ``all_to_all_single``; each rank composites its own horizontal slab
  of rows, and the slabs are all-gathered into the full image.  A slab is
  binned on whole tiles of the image's own grid, its pair runs at one
  card's window offsets (:func:`render_slab_tiled`), so the image equals
  one card's ``render_tiled``.
  Compositing is order-dependent in depth, so shards cannot be composited
  locally and summed: gather the compact records, composite the slab.
* **data parallelism, axis "d"**: the frames of a trajectory batch.

Where ``splat_tpu`` runs one ``shard_map`` over global arrays, the port runs
one process per rank (SPMD: every rank calls every function here in the
same order, as every collective needs).  The functions take **the rank's
own contiguous shard** of the scene (rows ``[g N/n_g, (g + 1) N/n_g)``,
the rows of ``P("g")``; :func:`shard_scene` cuts it), every rank is given
the full list of cameras of a batch and takes its contiguous ``F/n_d``
frames, and every rank returns what ``splat_tpu``'s replicated output
holds: the full image, the full ``(F, H, W, C)`` batch, the summed
overflow.  The renders take a shard of either layout, a ``GaussianScene``
or a packed ``DeviceScene`` (``pack_device()``, sharded by
:func:`shard_scene`), as ``splat_tpu``'s do; training takes the
``GaussianScene``.

The collectives run on the scene's device: NCCL on the card, gloo only for
CPU tensors (:func:`make_mesh`); a tensor is never copied through the host
to reach a collective.  Every rank's slab is rasterized by the port's
kernels: K1 (``build_tile_bins``) and K2 (``rasterize_tiles``) on the
tiled renders, K3 and K4 (``core_from_proj``) in
:func:`render_slab_tiled_diff`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.ops.projection import (ProjectedGaussians,
                                            project_gaussians)
from splat_tpu_torch.render.binning import (TileBins, build_tile_bins,
                                            decode_radius_bits,
                                            quantize_radius_bits, tile_spans)
from splat_tpu_torch.render.dense import composite_rows, depth_order
from splat_tpu_torch.render.diff import (_check_config, core_from_proj,
                                         finish_image)
from splat_tpu_torch.render.kernels import rasterize_tiles
from splat_tpu_torch.scene import DeviceScene

MESH_DIMS = ("d", "g")
# Rows of a packed projected record: center (2), conic (3), radius (2),
# color (3), opacity, depth, visible; the kernel-facing compact payload.
RECORD_ROWS = 13


def make_mesh(n_data: int = 1, n_gaussian: int | None = None,
              device=None):
    """A ``(d, g)`` DeviceMesh over the default process group, ranks in
    row-major order (rank = d * n_g + g, as ``np.reshape`` lays out
    ``splat_tpu``'s devices).  ``n_gaussian`` defaults to every rank not on
    ``d``.  ``device`` is where the tensors rendered on the mesh live
    (default cuda): the card needs the NCCL backend, the CPU gloo, and
    nothing is copied through the host to bridge them.

    Start the ranks first (``torchrun``, or
    :mod:`splat_tpu_torch.parallel.dryrun`) with
    ``torch.distributed.init_process_group``; on the card each rank sets
    ``torch.cuda.set_device(local_rank)`` before it and builds its scene
    and cameras with ``device=torch.device("cuda", local_rank)``: the
    constructors' default is cuda:0 on every rank, and the renders and
    ``fit(mesh=)`` refuse a tensor on another card than the rank's."""
    from torch.distributed.device_mesh import init_device_mesh

    total = dist.get_world_size() if dist.is_initialized() else 1
    if n_gaussian is None:
        n_gaussian = total // n_data
    if n_data * n_gaussian != total:
        raise ValueError(f"mesh {n_data}x{n_gaussian} != {total} ranks")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; call "
                           "torch.distributed.init_process_group first")
    dev_type = torch.device(device if device is not None else "cuda").type
    want = {"cuda": "nccl", "cpu": "gloo"}.get(dev_type)
    backend = dist.get_backend()
    if want is None or backend != want:
        raise ValueError(
            f"a mesh for {dev_type} tensors needs the "
            f"{want or 'nccl or gloo'} backend; the default process group "
            f"runs {backend}")
    return init_device_mesh(dev_type, (n_data, n_gaussian),
                            mesh_dim_names=MESH_DIMS)


def _axis(mesh, name: str):
    """(process group, size, this rank's index) of a mesh axis."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None or tuple(names) != MESH_DIMS:
        raise ValueError(f"need a (d, g) DeviceMesh from make_mesh, got "
                         f"{mesh!r}")
    i = names.index(name)
    return mesh.get_group(i), mesh.shape[i], mesh.get_local_rank(i)


def _check_device(mesh, t) -> None:
    """``t`` (a tensor or a scene of either layout) lies where the mesh's
    ranks compute: on the CPU for gloo, and for NCCL on this rank's own
    card, the current device (a scene or camera built without
    ``device=`` lands on cuda:0 on every rank)."""
    _axis(mesh, "g")
    if mesh.device_type != t.device.type:
        raise ValueError(
            f"tensors on {t.device} cannot take part in a mesh of "
            f"{mesh.device_type} ranks (no copy through the host)")
    if t.device.type == "cuda" and t.device.index != \
            torch.cuda.current_device():
        raise ValueError(
            f"tensors on {t.device}, but this rank computes on "
            f"cuda:{torch.cuda.current_device()}: build each rank's scene "
            f"and cameras with device=torch.device('cuda', local_rank) "
            f"after torch.cuda.set_device(local_rank)")


def shard_scene(scene, mesh):
    """This rank's contiguous shard of a whole ``GaussianScene``,
    ``RawParams`` (any dataclass of (N, ...) tensors) or ``DeviceScene``:
    gaussians ``[g N/n_g, (g + 1) N/n_g)``, the shard ``P("g")`` gives in
    ``splat_tpu``.  N must divide by the ``g`` axis (``pad_to`` pads).
    A DeviceScene's shard is the columns of its buffer, the rows
    re-viewed (still dense)."""
    _, n_g, g = _axis(mesh, "g")
    fields = [f.name for f in dataclasses.fields(scene)]
    n = getattr(scene, fields[0]).shape[0]
    if n % n_g:
        raise ValueError(f"{n} gaussians not divisible by the mesh 'g' "
                         f"axis {n_g}; pad_to a multiple first")
    m = n // n_g
    if isinstance(scene, DeviceScene):
        return DeviceScene.from_buffer(scene.buffer[:, g * m:(g + 1) * m])
    return dataclasses.replace(scene, **{
        k: getattr(scene, k)[g * m:(g + 1) * m] for k in fields})


def _check_sharded_config(config: RenderConfig) -> None:
    """Depth mode's auto range is a reduction over the visible splats of
    one call; each rank would normalize by its own shard's range and the
    slabs would disagree.  Sharded renders need an explicit range."""
    if config.render_mode == "depth" and config.depth_range is None:
        raise ValueError(
            "sharded rendering with render_mode='depth' requires an "
            "explicit RenderConfig.depth_range: the auto range would be "
            "computed per gaussian shard and ranks would disagree")


def _pack(proj: ProjectedGaussians) -> torch.Tensor:
    """(N, RECORD_ROWS) f32 records.  Depth, radius and visibility carry
    no gradient: binning reads them, the kernels' backward does not."""
    return torch.cat([proj.center_px, proj.conic, proj.radius_px.detach(),
                      proj.color, proj.opacity[:, None],
                      proj.depth.detach()[:, None],
                      proj.visible.to(torch.float32)[:, None]], dim=1)


def _unpack(rec: torch.Tensor, visible=None) -> ProjectedGaussians:
    return ProjectedGaussians(
        depth=rec[:, 11], center_px=rec[:, 0:2], conic=rec[:, 2:5],
        radius_px=rec[:, 5:7], color=rec[:, 7:10], opacity=rec[:, 10],
        visible=rec[:, 12] > 0.5 if visible is None else visible)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in group-rank order."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _gather_records(proj: ProjectedGaussians, group) -> ProjectedGaussians:
    """Every rank's projected records, in one collective."""
    return _unpack(_all_gather(_pack(proj), group))


class _GatherRecords(torch.autograd.Function):
    """Forward: all_gather of every rank's records over the group.
    Backward: reduce_scatter (sum) of the cotangents, so each record's
    owner receives the sum of what every rank's slab sent it."""

    @staticmethod
    def forward(ctx, rec, group):
        ctx.group = group
        ctx.n_local = rec.shape[0]
        return _all_gather(rec, group)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((ctx.n_local,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


class _GatherSlabs(torch.autograd.Function):
    """Forward: all_gather of the row slabs into the full image.
    Backward: this rank's own rows of the cotangent, with no
    communication.  Every rank computes the same loss of the same full
    image, so each already holds the full cotangent; summing it over the
    ranks (the backward of ``torch.distributed.nn``'s all_gather) would
    make every gradient n_g times too large."""

    @staticmethod
    def forward(ctx, slab, group):
        ctx.rows = slab.shape[0]
        ctx.rank = dist.get_rank(group)
        return _all_gather(slab, group)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.rank * ctx.rows
        return g[r0:r0 + ctx.rows], None


def _empty_frame(h: int, w: int, config: RenderConfig, device):
    """Pure background for N = 0 (RGBA gets zero coverage)."""
    bgc = tuple(config.background)
    if config.alpha_channel:
        bgc = bgc + (0.0,)
    return torch.tensor(bgc, dtype=torch.float32, device=device).expand(
        h, w, len(bgc)).clone()


def _slab_rows(h: int, n_g: int) -> int:
    if h % n_g:
        raise ValueError(f"image height {h} not divisible by g={n_g}")
    return h // n_g


def _local_frames(cameras, mesh) -> list:
    """This rank's contiguous F / n_d cameras of the batch."""
    cameras = list(cameras)
    _, n_d, d = _axis(mesh, "d")
    if len(cameras) % n_d:
        raise ValueError(f"{len(cameras)} frames not divisible by the mesh "
                         f"'d' axis {n_d}")
    f = len(cameras) // n_d
    return cameras[d * f:(d + 1) * f]


def render_sharded(scene, camera, mesh, config: RenderConfig | None = None,
                   chunk: int = 16) -> torch.Tensor:
    """One frame, gaussians sharded over the mesh axis 'g', each rank's
    slab composited densely (as ``render_dense``).  ``scene`` is this
    rank's shard; H must divide by the 'g' size.  Returns the full
    (H, W, 3) image on every rank (RGB only, as in ``splat_tpu``)."""
    config = config or RenderConfig()
    _check_sharded_config(config)
    h, w = camera.h, camera.w
    dev = scene.device
    if scene.num_gaussians == 0:
        return _empty_frame(h, w, config, dev)[..., :3]
    _check_device(mesh, scene)
    group, n_g, g = _axis(mesh, "g")
    h_local = _slab_rows(h, n_g)
    proj = _gather_records(project_gaussians(scene, camera.to(dev), config),
                           group)
    img, transmit = composite_rows(proj, depth_order(proj), g * h_local,
                                   h_local, w, config, chunk)
    bg = torch.tensor(config.background, dtype=torch.float32, device=dev)
    slab = torch.clamp(img + transmit[..., None] * bg, 0.0, 1.0)
    return _all_gather(slab, group)


def render_batch_sharded(scene, cameras, mesh,
                         config: RenderConfig | None = None,
                         chunk: int = 16) -> torch.Tensor:
    """A trajectory batch: frames over 'd', gaussians over 'g'.
    ``cameras`` is the full list (``orbit_trajectory``, ``stack_cameras``),
    its length divisible by the 'd' size.  Returns (F, H, W, 3)."""
    config = config or RenderConfig()
    _check_sharded_config(config)
    cameras = list(cameras)
    c0 = cameras[0]
    if scene.num_gaussians == 0:
        bg = _empty_frame(c0.h, c0.w, config, scene.device)[..., :3]
        return bg.expand((len(cameras),) + tuple(bg.shape)).clone()
    local = _local_frames(cameras, mesh)
    imgs = torch.stack([render_sharded(scene, c, mesh, config, chunk)
                        for c in local])
    return _all_gather(imgs, _axis(mesh, "d")[0])


def _slab_reach(radius_px: torch.Tensor, visible: torch.Tensor):
    """Each record's half-height as the kernels' box test takes it: the
    radius ceil-quantized to 1/8 px (``quantize_radius_bits``)."""
    return decode_radius_bits(quantize_radius_bits(
        radius_px[:, 0].detach(), radius_px[:, 1].detach(), visible))[1]


def _meets_slab(cy: torch.Tensor, ry: torch.Tensor, row0, rows):
    """Where a box of centre row ``cy`` and half-height ``ry`` from
    :func:`_slab_reach` (both in the image's frame, as binning reads them)
    reaches the rows [row0, row0 + rows).  Pixel centres lie half a pixel
    inside those rows, so every pair of the single-device render that
    touches them is kept.  On a frame of whole tiles (:func:`_tile_frame`,
    a power-of-two tile height) it keeps exactly the gaussians that the
    single-device binning puts in the frame's tiles: binning clamps a box
    into the grid, so a wider gate would add the boxes that end outside
    the frame to its edge tiles, and with them pairs that move K2's exit.
    Both routes gate with it (``splat_tpu`` gates with the unquantized
    radius and loses the pairs that reach a slab only through the
    quantization).  ``row0`` and ``rows`` may be (n, 1) tensors."""
    return (cy + ry >= row0) & (cy - ry < row0 + rows)


def _slab_view(proj: ProjectedGaussians, row0: int,
               h_local: int) -> ProjectedGaussians:
    """The records in the frame of the rows [row0, row0 + h_local):
    centres shifted up by row0, visibility re-gated to the splats whose
    box reaches those rows (:func:`_meets_slab`)."""
    cy = proj.center_px[:, 1]
    ry = _slab_reach(proj.radius_px, proj.visible)
    return dataclasses.replace(
        proj, center_px=torch.stack([proj.center_px[:, 0],
                                     cy - float(row0)], dim=-1),
        visible=proj.visible & _meets_slab(cy, ry, row0, h_local))


def _tile_frame(row0, h_local: int, tile_h: int):
    """(first row, rows) of the frame the row slab [row0, row0 + h_local)
    is binned and composited in: the whole tile rows of the image's own
    tile grid that hold the slab.  Each of the slab's tiles then holds the
    pixels of the single-device render's tile there, and K2's whole-tile
    exit, which every pixel of a tile votes on (those past the image's
    last row too), can fall where it falls on one device; a slab binned
    from its own first row cuts every tile elsewhere.  ``row0`` may be an
    int tensor (one slab a row)."""
    top = row0 - row0 % tile_h
    return top, (row0 + h_local + tile_h - 1) // tile_h * tile_h - top


def _pairs_above(proj: ProjectedGaussians, tile_row, w: int,
                 config: RenderConfig) -> torch.Tensor:
    """The pairs that the single-device binning of the records ``proj``
    puts in the tile rows above ``tile_row`` (an int, or an (n, 1) int
    tensor: then one count a row), int64: where one card's pair buffer
    starts the runs of that tile row.  Culled pairs (``cull_pairs``) leave
    the runs; this count keeps them."""
    rbits = quantize_radius_bits(proj.radius_px[:, 0], proj.radius_px[:, 1],
                                 proj.visible)
    tx0, ty0, span_w, counts = tile_spans(
        proj.center_px[:, 0], proj.center_px[:, 1], rbits, config.tile_w,
        config.tile_h, -(-w // config.tile_w), 1 << 30)
    span_h = counts // torch.clamp(span_w, min=1)
    rows = torch.clamp(torch.clamp(ty0 + span_h, max=tile_row) - ty0, min=0)
    return (span_w.to(torch.int64) * rows).sum(dim=-1)


def _at_offset(bins: TileBins, offset: torch.Tensor,
               chunk: int) -> TileBins:
    """``bins`` with its pair runs moved ``offset`` < ``chunk`` columns on
    (a () int64 tensor on the device: no host sync), so that K2's windows
    fall on them as on one card's buffer.  Inference only: ``ranks``
    stays where it was."""
    feats = bins.features
    if feats.shape[1] == 0:
        return bins
    src = torch.arange(feats.shape[1] + chunk, device=feats.device) - offset
    off = offset.to(torch.int32)
    return dataclasses.replace(
        bins, features=feats[:, src.clamp(0, feats.shape[1] - 1)],
        tile_start=bins.tile_start + off, tile_end=bins.tile_end + off)


def render_slab_tiled(proj: ProjectedGaussians, row0: int, h_local: int,
                      w: int, config: RenderConfig,
                      pairs_above: torch.Tensor | None = None):
    """Tile-binned rasterization of the row slab [row0, row0 + h_local),
    equal to the rows of one card's ``render_tiled`` of the same records:

    * the records are moved into the slab's frame of whole tiles of the
      image's own grid (:func:`_tile_frame`, :func:`_slab_view`) and
      binned (K1) and composited (K2) there, and the slab's rows cut out;
    * K2 walks a tile's pairs in ``chunk``-pair windows aligned to the
      pair buffer's own offsets (``splat_tpu``'s windows) and checks its
      whole-tile exit once a window, so the slab's runs are moved to where
      one card's buffer starts them, modulo ``chunk``: after the
      ``pairs_above`` pairs that one card bins in the tile rows above the
      frame (default: counted from ``proj``, which must then hold every
      record, as the gather route's does).

    Slabs cut from their own first rows and buffers put 23% of the pixels
    of the 1M random frame @1080p, split over four H100s, more than 1e-6
    off one card's.  Returns (slab image, binning overflow)."""
    top, rows = _tile_frame(row0, h_local, config.tile_h)
    if pairs_above is None:
        pairs_above = _pairs_above(proj, top // config.tile_h, w, config)
    bins = build_tile_bins(_slab_view(proj, top, rows), rows, w, config)
    img = rasterize_tiles(
        _at_offset(bins, pairs_above % config.chunk, config.chunk), rows, w,
        config)
    return img[row0 - top:row0 - top + h_local], bins.overflow


def _resolve_route(route: str, n_g: int) -> str:
    """'auto': gather below 6 ranks on 'g', a2a from 6 on (the crossover
    of ``splat_tpu``: with the default cap min(1, 4/n_g) N_local a rank
    sends n_g cap records by a2a and receives (n_g - 1) N_local by gather,
    so a2a carries less only past n_g = 5)."""
    if route == "auto":
        return "a2a" if n_g >= 6 else "gather"
    if route not in ("a2a", "gather"):
        raise ValueError(
            f"route must be 'auto', 'a2a' or 'gather', got {route!r}")
    return route


def _slab_frame(scene, camera, config, route, cap_factor, group, n_g, g,
                h_local):
    """One frame's (full image, this rank's routing + binning overflow)."""
    proj = project_gaussians(scene, camera.to(scene.device), config)
    above = None             # the gather route's slab counts it itself
    if route == "gather":
        proj = _gather_records(proj, group)
        overflow = torch.zeros((), dtype=torch.int64, device=scene.device)
    else:
        # every slab's pairs above its frame, summed over the ranks' records
        top, _ = _tile_frame(torch.arange(n_g, device=scene.device)[:, None]
                             * h_local, h_local, config.tile_h)
        above = _pairs_above(proj, top // config.tile_h, camera.w, config)
        dist.all_reduce(above, group=group)
        above = above[g]
        proj, overflow = _route_records_by_slab(proj, n_g, h_local,
                                                cap_factor, group,
                                                config.tile_h)
    slab, bin_ov = render_slab_tiled(proj, g * h_local, h_local, camera.w,
                                     config, above)
    return _all_gather(slab, group), overflow + bin_ov


def _prepare_tiled(scene, mesh, route, slab_cap_factor, h):
    """The route, cap factor, 'g' axis and slab rows of a tiled render."""
    _check_device(mesh, scene)
    group, n_g, g = _axis(mesh, "g")
    h_local = _slab_rows(h, n_g)
    route = _resolve_route(route, n_g)
    if route == "a2a" and slab_cap_factor is None:
        slab_cap_factor = _auto_cap_factor(scene, n_g, group)
    return route, slab_cap_factor, group, n_g, g, h_local


def render_sharded_tiled(scene, camera, mesh,
                         config: RenderConfig | None = None,
                         route: str = "auto",
                         slab_cap_factor: float | None = None):
    """One frame on the tiled path, gaussians sharded over 'g', each
    rank's row slab binned (K1) and composited (K2) by the port's
    kernels.  The projected records reach the slabs by

    * route="gather": every record to every rank (``all_gather``);
    * route="a2a": each rank compacts, per destination slab, the records
      whose box meets it, front-most first, up to ``cap =
      slab_cap_factor * N_local`` (default ``min(1, 4/n_g)``, raised for
      a scene stored in spatial order, see :func:`_auto_cap_factor`), and
      one ``all_to_all_single`` delivers them; records past the cap are
      dropped deepest first and counted;
    * route="auto": gather below 6 ranks on 'g', a2a from 6.

    Returns ``(image, overflow)``: the full image on every rank and the
    sum over 'g' of routing and binning overflow (0: nothing dropped).
    Callers that do not audit it use :func:`render_sharded_tiled_checked`.
    ``config.supersample`` is not applied, as in ``splat_tpu``."""
    config = config or RenderConfig()
    _check_sharded_config(config)
    h, w = camera.h, camera.w
    if scene.num_gaussians == 0:
        return (_empty_frame(h, w, config, scene.device),
                torch.zeros((), dtype=torch.int64, device=scene.device))
    route, factor, group, n_g, g, h_local = _prepare_tiled(
        scene, mesh, route, slab_cap_factor, h)
    img, overflow = _slab_frame(scene, camera, config, route, factor, group,
                                n_g, g, h_local)
    dist.all_reduce(overflow, group=group)
    return img, overflow


def render_batch_sharded_tiled(scene, cameras, mesh,
                               config: RenderConfig | None = None,
                               route: str = "auto",
                               slab_cap_factor: float | None = None):
    """A trajectory batch on the tiled path: frames over 'd' (each rank
    takes its contiguous F / n_d of the full list ``cameras``), gaussians
    over 'g', the records of every frame routed as in
    :func:`render_sharded_tiled`.  Returns ((F, H, W, C) images, overflow
    summed over 'g' and 'd')."""
    config = config or RenderConfig()
    _check_sharded_config(config)
    cameras = list(cameras)
    h, w = cameras[0].h, cameras[0].w
    if scene.num_gaussians == 0:
        bg = _empty_frame(h, w, config, scene.device)
        return (bg.expand((len(cameras),) + tuple(bg.shape)).clone(),
                torch.zeros((), dtype=torch.int64, device=scene.device))
    route, factor, group, n_g, g, h_local = _prepare_tiled(
        scene, mesh, route, slab_cap_factor, h)
    local = _local_frames(cameras, mesh)
    overflow = torch.zeros((), dtype=torch.int64, device=scene.device)
    imgs = []
    for cam in local:
        img, ov = _slab_frame(scene, cam, config, route, factor, group, n_g,
                              g, h_local)
        imgs.append(img)
        overflow = overflow + ov
    dist.all_reduce(overflow, group=group)
    d_group = _axis(mesh, "d")[0]
    dist.all_reduce(overflow, group=d_group)
    return _all_gather(torch.stack(imgs), d_group), overflow


def _raise_on_overflow(overflow: int) -> None:
    if overflow > 0:
        raise RuntimeError(
            f"sharded render truncated: {overflow} records/pairs dropped "
            f"(routing slab cap and/or tile duplication buffer too small); "
            f"raise slab_cap_factor and/or RenderConfig.max_dup_factor")


def render_sharded_tiled_checked(scene, camera, mesh,
                                 config: RenderConfig | None = None,
                                 route: str = "auto",
                                 slab_cap_factor: float | None = None):
    """render_sharded_tiled that raises on any truncation (one host sync
    a frame; hot loops audit the returned count themselves)."""
    img, overflow = render_sharded_tiled(scene, camera, mesh, config,
                                         route=route,
                                         slab_cap_factor=slab_cap_factor)
    _raise_on_overflow(int(overflow))
    return img


def render_batch_sharded_tiled_checked(scene, cameras, mesh,
                                       config: RenderConfig | None = None,
                                       route: str = "auto",
                                       slab_cap_factor: float | None = None):
    """render_batch_sharded_tiled that raises on any truncation."""
    imgs, overflow = render_batch_sharded_tiled(
        scene, cameras, mesh, config, route=route,
        slab_cap_factor=slab_cap_factor)
    _raise_on_overflow(int(overflow))
    return imgs


def render_slab_tiled_diff(scene, camera, config: RenderConfig, mesh):
    """Differentiable tensor-parallel tiled render, called on every rank
    with its shard ``scene`` of the gaussians.  Returns the full (H, W, C)
    image, the same on every rank.

    Each rank projects its shard (autograd reaches the shard's tensors),
    all-gathers the records in one collective, rasterizes its row slab
    (:func:`_slab_view`) through the training kernels K3/K4
    (``core_from_proj``), finalizes as
    ``render_tiled_diff`` does, and all-gathers the slabs.  Backward: the
    slab gather hands each rank its own rows of the image cotangent, and
    the record gather's reduce-scatter sums every slab's cotangents into
    the records' owners, so each rank's gradients are those of its shard
    under the single-device loss, 1x, not n_g x.  Parameters, gradients
    and optimizer state stay sharded; only the records and the image are
    replicated.  Needs supersample == 1 and H divisible by the 'g' size."""
    if config.supersample != 1:
        raise NotImplementedError(
            "TP training with supersample > 1 is not supported")
    _check_sharded_config(config)
    _check_config(config)
    _check_device(mesh, scene)
    group, n_g, g = _axis(mesh, "g")
    h, w = camera.h, camera.w
    h_local = _slab_rows(h, n_g)
    proj = project_gaussians(scene, camera.to(scene.device), config)
    p = _slab_view(_unpack(_GatherRecords.apply(_pack(proj), group)),
                   g * h_local, h_local)
    c_raw, lt = core_from_proj(p, h_local, w, config)
    return _GatherSlabs.apply(finish_image(c_raw, lt, config), group)


def _means(scene) -> torch.Tensor:
    """(N, 3) centres of a scene of either layout (a DeviceScene's rows
    stacked)."""
    if isinstance(scene, DeviceScene):
        return torch.stack([scene.mx, scene.my, scene.mz], dim=1)
    return scene.means


def _score_from_bounds(mins: np.ndarray, maxs: np.ndarray) -> float:
    """Median over the shards of the fraction of the scene's bounding
    volume each shard's box covers; (n_g, 3) f32 bounds."""
    ext = maxs.max(axis=0) - mins.min(axis=0) + 1e-12
    fracs = [float(np.prod(np.clip((hi - lo) / ext, 1e-6, 1.0)))
             for lo, hi in zip(mins, maxs)]
    return float(np.median(fracs))


def shard_spatial_score(scene, n_g: int) -> float:
    """How far the scene's storage order is from spatially uncorrelated
    across ``n_g`` contiguous shards: the median fraction of the scene's
    bounding volume each shard's own box covers.  ~1.0 for a random
    order (the a2a route's default cap holds); << 1 for a scene stored in
    spatial order (a y-sorted export scores ~1/n_g), whose shards' records
    crowd into few slabs.  Takes the whole scene; a tensor's means are
    copied to the host once (``splat_tpu`` skips device arrays because a
    fetch from its remote TPU is slow; a copy from the card is not)."""
    means = _means(scene).detach().cpu().numpy()
    if means.shape[0] < 2 * n_g:
        return 1.0
    shards = np.array_split(means, n_g)
    return _score_from_bounds(np.stack([s.min(axis=0) for s in shards]),
                              np.stack([s.max(axis=0) for s in shards]))


def _sharded_score(scene, n_g: int, group) -> float:
    """shard_spatial_score of the whole scene from this rank's shard: the
    shards' boxes (6 floats each) all-gathered, then copied to the host."""
    if scene.num_gaussians * n_g < 2 * n_g:
        return 1.0
    m = _means(scene).detach()
    box = torch.stack([m.amin(dim=0), m.amax(dim=0)])          # (2, 3)
    boxes = _all_gather(box, group).cpu().numpy().reshape(n_g, 2, 3)
    return _score_from_bounds(boxes[:, 0], boxes[:, 1])


# Below this score a scene is treated as spatially ordered: a random order
# scores ~0.9+, y-sorted ~1/n_g and octree-ordered ~(1/2)^3.
_SPATIAL_SCORE_THRESHOLD = 0.35

def _auto_cap_factor(scene, n_g: int, group=None) -> float:
    """Slab-cap factor for route='a2a' when the caller pins none: the
    default ``min(1, 4/n_g)`` for scenes in random order, raised toward
    1.0 (replication's traffic, which never overflows on routing) when the
    spatial score says the shards are clustered.  ``scene`` is the whole
    scene, or with ``group`` this rank's shard of it (the score then comes
    from the shards' boxes, gathered over ``group``).

    The factor is memoized on the scene object, per (N, n_g), so a hit
    depends only on whether this object was scored before.  Every rank of
    an SPMD program passes its shard object through the same calls, so
    all hit or all miss and join the gather together; a memo kept in a
    table of the process (``splat_tpu`` keys one by ``id(scene)`` and
    empties it past 256 entries) could be emptied on one rank alone."""
    default = min(1.0, 4.0 / n_g)
    n = scene.num_gaussians * (n_g if group is not None else 1)
    memo = scene.__dict__.setdefault("_cap_factor_memo", {})
    if (n, n_g) in memo:
        return memo[(n, n_g)]
    score = (shard_spatial_score(scene, n_g) if group is None
             else _sharded_score(scene, n_g, group))
    out = default
    if score < _SPATIAL_SCORE_THRESHOLD:
        out = min(1.0, max(default, default / max(score, 1e-3)))
    memo[(n, n_g)] = out
    return out


def prepare_scene_for_sharding(scene, n_g: int, *, seed: int = 0,
                               threshold: float = _SPATIAL_SCORE_THRESHOLD):
    """De-cluster a whole scene stored in spatial order before sharding:
    ``(scene.permuted(seed), True)`` when its spatial score is below
    ``threshold``, else ``(scene, False)``.  Cheaper at scale than the
    raised cap of :func:`_auto_cap_factor`."""
    if shard_spatial_score(scene, n_g) < threshold:
        return scene.permuted(seed), True
    return scene, False


def slab_cap(n_local: int, cap_factor: float) -> int:
    """The slots each destination slab gets from a rank on the a2a route:
    ``cap_factor * n_local`` rounded up to a multiple of 128, at least
    128 and at most ``n_local``."""
    return min(max(128, -(-int(n_local * cap_factor) // 128) * 128),
               n_local)


def _route_records_by_slab(proj: ProjectedGaussians, n_g: int,
                           h_local: int, cap_factor: float | None, group,
                           tile_h: int):
    """Compact this rank's records per destination slab and route them by
    one ``all_to_all_single``.  Returns (the n_g * cap received records,
    this rank's routing overflow).

    Per destination, the records whose box meets the slab's frame of
    whole ``tile_h``-row tiles (:func:`_tile_frame`) as :func:`_slab_view`
    gates it (so both routes keep the same pairs; ``splat_tpu`` gates
    here with the unquantized radius, and its slab's own rows) are taken in
    front-to-back order (a stable sort by depth, as ``jnp.argsort``, so
    ties and with them the dropped records match ``splat_tpu``) into
    ``cap`` slots; those past the cap are counted.  Received block s comes
    from rank s; empty slots are zeros and invalid, and a second
    ``all_to_all_single`` carries the validity mask."""
    n_local = proj.depth.shape[0]
    dev = proj.depth.device
    if cap_factor is None:
        cap_factor = min(1.0, 4.0 / n_g)
    cap = slab_cap(n_local, cap_factor)

    top, rows = _tile_frame(
        torch.arange(n_g, device=dev)[:, None] * h_local, h_local, tile_h)
    touches = proj.visible[None, :] & _meets_slab(
        proj.center_px[None, :, 1],
        _slab_reach(proj.radius_px, proj.visible)[None, :],
        top.to(torch.float32), rows.to(torch.float32))       # (n_g, N_local)
    order = torch.argsort(torch.where(proj.visible, proj.depth,
                                      float("inf")), stable=True)
    rows = _pack(proj)[order]                                # (N_local, 13)
    cum = torch.cumsum(touches[:, order].to(torch.int64), dim=1)
    sent = cum[:, -1]
    overflow = torch.clamp(sent - cap, min=0).sum()
    # slot j of destination d holds the (j + 1)-th record that touches d
    slot = torch.arange(cap, device=dev)
    src = torch.searchsorted(cum, (slot + 1).expand(n_g, cap).contiguous())
    valid = slot[None, :] < torch.clamp(sent, max=cap)[:, None]  # (n_g, cap)
    buf = torch.where(valid[..., None], rows[src.clamp(max=n_local - 1)],
                      torch.zeros((), device=dev))           # (n_g, cap, 13)
    recv = torch.empty_like(buf).view(n_g * cap, RECORD_ROWS)
    dist.all_to_all_single(recv, buf.view(n_g * cap, RECORD_ROWS),
                           group=group)
    ok = torch.empty(n_g * cap, dtype=torch.float32, device=dev)
    dist.all_to_all_single(ok, valid.to(torch.float32).view(-1), group=group)
    return _unpack(recv, visible=(recv[:, 12] > 0.5) & (ok > 0.5)), overflow
