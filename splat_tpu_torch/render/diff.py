"""Differentiable tiled rendering: the training path (kernels K3 and K4).

Port of ``splat_tpu/render/diff.py``.  The autograd boundary sits where the
JAX package put its custom VJP: between the projected per-gaussian
quantities ``(center_px, conic, color, opacity)`` and the raw per-pixel
outputs ``(C, logT)``.  The port's own projection (``ops/projection.py``)
is plain PyTorch, so autograd carries the gradients on to the scene and
the camera, as ``jax.vjp`` does there.

* **Forward (K3, ``csrc/raster_train.cu``).**  The K2 walk without the
  1/255 exit.  Per pixel and kept pair: ``C += alpha * T * color``,
  ``T *= 1 - alpha'``, ``logT += log1p(-alpha')``, where
  ``alpha' = min(alpha, 0.999999)`` when ``alpha_clamp >= 0.999999`` and
  ``alpha`` otherwise.  It returns raw C (no background, no clip), logT and
  a per-tile cut: the number of windows walked.  Windows are ``chunk``
  pairs wide and start at ``(tile_start // 128) * 128``.  The saturation
  check runs after every ``SAT_CHECK_EVERY``-th window and then after each
  window of the tail.  The exact cut needs every pixel of the tile, pixels
  past the image edge included, at ``logT < sat_cut_log`` AND ``T == 0``:
  later pairs then add exact zeros to the image and to every gradient (see
  ``splat_tpu/render/diff.py`` on why a denormal-stalled ``T`` needs the
  second condition).  With ``config.train_sat_exit`` the cut is instead
  every pixel at ``T < alpha_min``.
* **Backward (K4).**  Per tile, the pairs of windows ``[0, cut)`` in
  reverse.  Each pixel starts at ``lt = logT`` and ``D = dL/dlogT``; per
  pair it recomputes alpha as K3 did, ``lt_i = lt - log1p(-alpha')``,
  ``T_i = exp(min(lt_i, 0))``, ``gc = sum_c dL/dC_c * color_c``,
  ``dalpha = T_i * gc - D / (1 - alpha')``, then ``D += gc * alpha * T_i``
  and ``lt = lt_i``.  ``dalpha`` chains through ``keep & unclamped`` into
  the pair's geometry, and the colour and opacity sums follow.  The sums
  over the tile's pixels give 9 values per pair, which are added to the
  pair's gaussian: an (N, 9) result in the order of ``GRAD_COLUMNS``.
* **Finalize** in plain PyTorch outside the autograd Function:
  ``clip(C + exp(logT) * bg)``, the coverage channel, supersampling.

The TPU kernel's window-padded per-pair gradient buffer, its gaussian-id
row, the sort by gaussian with its compensated segment sums and the
N >= 2^24 fallback exist to avoid a scatter on the TPU; on the card the
per-gaussian sum is an ``atomicAdd`` (``index_add_`` in the plain version).

CUDA tensors launch the kernels (or raise); CPU tensors take
:func:`rasterize_train_fwd_plain` / :func:`rasterize_train_bwd_plain`,
which do the kernels' float operations in the kernels' order.
"""

from __future__ import annotations

import math

import torch

from splat_tpu_torch import _build
from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.ops.projection import (ProjectedGaussians,
                                            project_gaussians)
from splat_tpu_torch.render.binning import (FEATURE_DIM, TileBins,
                                            build_tile_bins)
from splat_tpu_torch.render.kernels import _ppt, _untile
# the work list the kernels share with K2; the names stay importable here
from splat_tpu_torch.render import graph, plan
from splat_tpu_torch.render.plan import (BLOCKS_PER_SM,  # noqa: F401
                                         SPLIT_BLOCKS, SPLIT_MIN_PAIRS,
                                         THREADS,
                                         _block_work, _slots, _split,
                                         _tile_plan)
from splat_tpu_torch.utils.image import box_downsample

# exp(x) is exactly +0.0 in f32 for every x < ln(2^-150) ~ -103.97; -105
# leaves margin.  The default of the wrappers' ``sat_cut_log`` argument;
# -inf disables the exact cut.
SAT_CUT_LOG = -105.0
# the forward checks saturation once per this many windows (then after
# every tail window), as the TPU kernel does
SAT_CHECK_EVERY = 4
# windows start at this alignment below each tile's first pair
WINDOW_ALIGN = 128
# alpha' cap inside log1p and 1/(1 - alpha') for alpha_clamp >= it
ALPHA_LOG_CAP = 0.999999
# columns of the per-gaussian gradient K4 returns (feature rows 0-8)
GRAD_COLUMNS = ("cx", "cy", "a2", "b2", "c2", "r", "g", "b", "opacity")


def _check_config(config: RenderConfig) -> None:
    """The restrictions of ``splat_tpu``'s render_tiled_diff, so that one
    config behaves the same in both packages."""
    if config.render_mode == "depth":
        # gradients through a per-frame min/max depth range would couple
        # every splat to the current extremes
        if config.depth_range is None:
            raise NotImplementedError(
                "render_tiled_diff in depth mode needs an explicit "
                "config.depth_range=(near, far)")
    elif config.render_mode != "color":
        raise NotImplementedError(
            "render_tiled_diff supports render_mode='color' or 'depth' "
            f"(explicit depth_range), got {config.render_mode!r}")
    if config.binning_key != "depth":
        raise NotImplementedError(
            "render_tiled_diff requires binning_key='depth'")
    if config.subtile_exit or config.cull_pairs:
        raise NotImplementedError(
            "render_tiled_diff requires subtile_exit=False, "
            "cull_pairs=False")
    if not config.transmit_mxu:
        raise NotImplementedError(
            "render_tiled_diff requires transmit_mxu=True, as in splat_tpu")


def _log_cap(config: RenderConfig) -> float | None:
    """The alpha' cap, or None where alpha' = alpha."""
    return None if config.alpha_clamp < ALPHA_LOG_CAP else ALPHA_LOG_CAP


def _windows(bins: TileBins, chunk: int):
    """Per tile (int64): first pair, end, first window start, windows."""
    s = bins.tile_start.to(torch.int64)
    e = bins.tile_end.to(torch.int64)
    base = torch.div(s, WINDOW_ALIGN, rounding_mode="floor") * WINDOW_ALIGN
    nch = torch.div(e - base + chunk - 1, chunk, rounding_mode="floor")
    return s, e, base, nch


def _walk_end(bins: TileBins, chunk: int, cut):
    """Per tile (int64): one past the last pair of windows [0, cut)."""
    _, e, base, nch = _windows(bins, chunk)
    return torch.minimum(e, base + torch.minimum(cut.to(torch.int64), nch)
                         * chunk)


def _pixel_grid(bins: TileBins, config: RenderConfig, dev):
    """(T, P) float pixel coordinates of every tile pixel."""
    tw, th = config.tile_w, config.tile_h
    ntx = bins.tiles_x
    lin = torch.arange(tw * th, device=dev)
    tid = torch.arange(ntx * bins.tiles_y, device=dev)
    pxf = ((tid % ntx)[:, None] * tw + lin % tw).to(torch.float32)
    pyf = ((tid // ntx)[:, None] * th + lin // tw).to(torch.float32)
    return pxf, pyf


def _tile_pixels(img, bins: TileBins, config: RenderConfig):
    """(H, W, C) image -> (T, P, C) per-tile pixels, zero past the edge."""
    tw, th = config.tile_w, config.tile_h
    ntx, nty = bins.tiles_x, bins.tiles_y
    h, w, c = img.shape
    a = torch.nn.functional.pad(img, (0, 0, 0, ntx * tw - w, 0, nty * th - h))
    a = a.reshape(nty, th, ntx, tw, c).transpose(1, 2)
    return a.reshape(nty * ntx, th * tw, c)


def _alpha(f, px, py, config: RenderConfig, use_bbox: bool):
    """One pair's alpha at each pixel, as the kernels compute it.  ``f``
    holds the pair's feature rows, each broadcastable against px/py.
    Returns (alpha, a_raw, expp, keep, dx, dy, dx2, dy2)."""
    cx, cy, a2, b2, c2, _, _, _, op, rx2, ry2 = f
    dx = px - cx
    dy = cy - py
    dx2 = dx * dx
    dy2 = dy * dy
    power = a2 * dx2 + c2 * dy2 + b2 * (dx * dy)
    expp = torch.exp(power)
    a_raw = op * expp
    alpha = torch.clamp(a_raw, max=config.alpha_clamp)
    keep = alpha >= config.alpha_min
    if use_bbox:
        keep = keep & (dx2 <= rx2) & (dy2 <= ry2)
    return alpha, a_raw, expp, keep, dx, dy, dx2, dy2


def rasterize_train_fwd_plain(bins: TileBins, h: int, w: int,
                              config: RenderConfig, *,
                              sat_cut_log: float = SAT_CUT_LOG):
    """Plain PyTorch version of the K3 kernel (any device; differentiable
    by autograd with respect to ``bins.features``): all tiles step through
    their windows together, each window composited pair by pair."""
    tw, th = config.tile_w, config.tile_h
    ntx, nty = bins.tiles_x, bins.tiles_y
    nt, p, chunk = ntx * nty, tw * th, config.chunk
    feats = bins.features
    dev = feats.device
    kp = feats.shape[1]
    use_bbox = math.isfinite(config.sigma_cutoff)
    cap = _log_cap(config)

    s, e, base, nch = _windows(bins, chunk)
    n_full = torch.div(nch, SAT_CHECK_EVERY,
                       rounding_mode="floor") * SAT_CHECK_EVERY
    pxf, pyf = _pixel_grid(bins, config, dev)
    color = torch.zeros((nt, p, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((nt, p), dtype=torch.float32, device=dev)
    logt = torch.zeros((nt, p), dtype=torch.float32, device=dev)
    cut = torch.zeros(nt, dtype=torch.int64, device=dev)
    done = torch.zeros(nt, dtype=torch.bool, device=dev)
    lane = torch.arange(chunk, device=dev)

    for j in range(int(nch.max()) if nt else 0):
        act = torch.nonzero(~done & (nch > j)).flatten()
        if act.numel() == 0:
            break
        k = base[act, None] + j * chunk + lane                # (A, chunk)
        valid = (k >= s[act, None]) & (k < e[act, None])
        f = feats[:, k.clamp(0, max(kp - 1, 0))]              # (F, A, chunk)
        px, py = pxf[act], pyf[act]
        c_a, t_a, l_a = color[act], trans[act], logt[act]
        for i in range(chunk):
            v = valid[:, i]
            if not bool(v.any()):
                continue
            fi = [f[q, :, i, None] for q in range(FEATURE_DIM)]
            alpha, _, _, keep, _, _, _, _ = _alpha(fi, px, py, config,
                                                   use_bbox)
            keep = keep & v[:, None]
            a_log = alpha if cap is None else torch.clamp(alpha, max=cap)
            wgt = (alpha * t_a)[..., None]
            rgb = torch.stack(fi[5:8], dim=-1)                 # (A, 1, 3)
            c_a = torch.where(keep[..., None], c_a + wgt * rgb, c_a)
            t_a = torch.where(keep, t_a * (1.0 - a_log), t_a)
            l_a = torch.where(keep, l_a + torch.log1p(-a_log), l_a)
        # out of place, so that autograd can run through the walk
        color = color.index_put((act,), c_a)
        trans = trans.index_put((act,), t_a)
        logt = logt.index_put((act,), l_a)
        cut[act] = j + 1
        walked = j + 1
        check = (((walked % SAT_CHECK_EVERY == 0) & (walked <= n_full[act]))
                 | (walked > n_full[act]))
        tmax = t_a.detach().amax(dim=1)
        if config.train_sat_exit:
            sat = tmax < config.alpha_min
        else:
            sat = (l_a.detach().amax(dim=1) < sat_cut_log) & (tmax == 0.0)
        done[act] = check & sat

    c_img = _untile(color, nty, ntx, th, tw, h, w)
    lt_img = _untile(logt, nty, ntx, th, tw, h, w)
    return c_img, lt_img, cut.to(torch.int32)


def _check_common(bins: TileBins, h: int, w: int, config: RenderConfig):
    """Shapes and limits both training kernels need; returns (PPT, blocks
    per tile)."""
    dev = bins.features.device
    tw, th = config.tile_w, config.tile_h
    nt = bins.tiles_x * bins.tiles_y
    launch = _ppt(config)
    if bins.tiles_x * tw < w or bins.tiles_y * th < h:
        raise ValueError("tile grid does not cover the image")
    feats = bins.features
    if feats.dim() != 2 or feats.shape[1] >= 1 << 31:
        raise ValueError(f"features: need ({FEATURE_DIM}, K < 2^31), got "
                         f"{tuple(feats.shape)}")
    _build.check_tensor(feats, "features", torch.float32,
                        (FEATURE_DIM, feats.shape[1]), dev)
    for name, t in (("tile_start", bins.tile_start),
                    ("tile_end", bins.tile_end)):
        _build.check_tensor(t, name, torch.int32, (nt,), dev)
    return launch


def rasterize_train_fwd(bins: TileBins, h: int, w: int,
                        config: RenderConfig, *,
                        sat_cut_log: float = SAT_CUT_LOG):
    """The training forward: raw C (H, W, 3), logT (H, W) and the per-tile
    cut (T,) int32 (windows walked).

    CUDA tensors launch K3 in ``csrc/raster_train.cu`` (or raise); CPU
    tensors take :func:`rasterize_train_fwd_plain`.
    """
    feats = bins.features
    dev = feats.device
    if dev.type == "cpu":
        return rasterize_train_fwd_plain(bins, h, w, config,
                                         sat_cut_log=sat_cut_log)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_train_fwd: unsupported device {dev}")
    ppt, groups = _check_common(bins, h, w, config)
    nt = bins.tiles_x * bins.tiles_y
    c_img = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    lt_img = torch.empty((h, w), dtype=torch.float32, device=dev)
    cut = torch.empty((nt,), dtype=torch.int32, device=dev)
    if nt == 0 or h == 0 or w == 0:
        return c_img, lt_img, cut
    # the launch's work list, built on the card: tile ids, then the count
    # of split tiles
    work = torch.empty((nt + 1,), dtype=torch.int32, device=dev)
    fn = _build.library().splat_rasterize_train_fwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bins.tile_start.data_ptr(), bins.tile_end.data_ptr(),
                 work.data_ptr(), work.data_ptr() + 4 * nt,
                 feats.data_ptr(), feats.shape[1], c_img.data_ptr(),
                 lt_img.data_ptr(), cut.data_ptr(), h, w, config.tile_w,
                 config.tile_h, bins.tiles_x, nt, config.chunk,
                 config.alpha_clamp, config.alpha_min,
                 int(_log_cap(config) is not None), float(sat_cut_log),
                 int(config.train_sat_exit),
                 int(math.isfinite(config.sigma_cutoff)), ppt, groups,
                 plan._slots(dev), plan.SPLIT_MIN_PAIRS, stream)
    _build.check(err, "rasterize_train_fwd")
    rasterize_train_fwd.launches += 1
    rasterize_train_fwd.split_tiles = work[nt:]
    return c_img, lt_img, cut


rasterize_train_fwd.launches = 0
# the last launch's count of split tiles, a (1,) int32 tensor on the card
rasterize_train_fwd.split_tiles = None
graph.count_replays(rasterize_train_fwd, ("launches",),
                    last=("split_tiles",))


def rasterize_train_bwd_plain(bins: TileBins, g_c, g_lt, lt, cut, h: int,
                              w: int, config: RenderConfig):
    """Plain PyTorch version of the K4 kernel (any device): every tile
    walks its pairs in reverse, one pair per step, all tiles together;
    ``index_add_`` sums the pairs into their gaussians."""
    feats = bins.features
    dev = feats.device
    kp = feats.shape[1]
    use_bbox = math.isfinite(config.sigma_cutoff)
    cap = _log_cap(config)

    gc_t = _tile_pixels(g_c, bins, config)                     # (T, P, 3)
    glt_t = _tile_pixels(g_lt[..., None], bins, config)[..., 0]
    lt_t = _tile_pixels(lt[..., None], bins, config)[..., 0]
    inside = _tile_pixels(torch.ones((h, w, 1), dtype=torch.bool,
                                     device=dev), bins, config)[..., 0]
    pxf, pyf = _pixel_grid(bins, config, dev)
    s, e, base, nch = _windows(bins, config.chunk)
    kend = torch.minimum(e, base + torch.minimum(cut.to(torch.int64), nch)
                         * config.chunk)
    npairs = torch.clamp(kend - s, min=0)
    d_acc, l_acc = glt_t.clone(), lt_t.clone()
    pair_g = torch.zeros((kp, len(GRAD_COLUMNS)), dtype=torch.float32,
                         device=dev)

    for step in range(int(npairs.max()) if npairs.numel() else 0):
        act = torch.nonzero(npairs > step).flatten()
        k = kend[act] - 1 - step                                # (A,)
        fk = feats[:, k]
        f = [fk[q, :, None] for q in range(FEATURE_DIM)]       # (A, 1) each
        px, py = pxf[act], pyf[act]
        alpha, a_raw, expp, keep, dx, dy, dx2, dy2 = _alpha(
            f, px, py, config, use_bbox)
        keep = keep & inside[act]
        a_log = alpha if cap is None else torch.clamp(alpha, max=cap)
        d_a, l_a = d_acc[act], l_acc[act]
        l_i = l_a - torch.log1p(-a_log)
        t_i = torch.exp(torch.clamp(l_i, max=0.0))
        g = gc_t[act]
        gcw = g[..., 0] * f[5] + g[..., 1] * f[6] + g[..., 2] * f[7]
        wgt = alpha * t_i
        da = t_i * gcw - d_a / (1.0 - a_log)
        mask = keep & (a_raw < config.alpha_clamp)
        zero = torch.zeros_like(da)
        dp = torch.where(mask, da * alpha, zero)
        wk = torch.where(keep, wgt, zero)
        r_dx = (dp * dx).sum(1)
        r_dy = (dp * dy).sum(1)
        a2, b2, c2 = f[2][:, 0], f[3][:, 0], f[4][:, 0]
        pair_g[k] = torch.stack([
            -(2.0 * a2 * r_dx + b2 * r_dy),
            2.0 * c2 * r_dy + b2 * r_dx,
            (dp * dx2).sum(1), (dp * (dx * dy)).sum(1), (dp * dy2).sum(1),
            (g[..., 0] * wk).sum(1), (g[..., 1] * wk).sum(1),
            (g[..., 2] * wk).sum(1),
            torch.where(mask, da * expp, zero).sum(1)], dim=1)
        d_acc[act] = torch.where(keep, d_a + gcw * wgt, d_a)
        l_acc[act] = torch.where(keep, l_i, l_a)

    out = torch.zeros((bins.num_gaussians, len(GRAD_COLUMNS)),
                      dtype=torch.float32, device=dev)
    # unwalked and unused slots hold zeros, whatever gaussian they name
    return out.index_add_(0, bins.ranks, pair_g)


def rasterize_train_bwd(bins: TileBins, g_c, g_lt, lt, cut, h: int, w: int,
                        config: RenderConfig):
    """The training backward: per-gaussian gradients (N, 9) of
    ``sum(g_c * C) + sum(g_lt * logT)`` with respect to the feature rows
    in ``GRAD_COLUMNS`` (the prescaled conic rows, clipped colour).

    g_c: (H, W, 3); g_lt, lt: (H, W); cut: (T,) int32 from the forward.
    CUDA tensors launch K4 in ``csrc/raster_train.cu`` (or raise); CPU
    tensors take :func:`rasterize_train_bwd_plain`.
    """
    feats = bins.features
    dev = feats.device
    if dev.type == "cpu":
        return rasterize_train_bwd_plain(bins, g_c, g_lt, lt, cut, h, w,
                                         config)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_train_bwd: unsupported device {dev}")
    ppt, groups = _check_common(bins, h, w, config)
    nt = bins.tiles_x * bins.tiles_y
    _build.check_tensor(bins.ranks, "ranks", torch.int64, (feats.shape[1],),
                        dev)
    _build.check_tensor(g_c, "g_c", torch.float32, (h, w, 3), dev)
    _build.check_tensor(g_lt, "g_lt", torch.float32, (h, w), dev)
    _build.check_tensor(lt, "lt", torch.float32, (h, w), dev)
    _build.check_tensor(cut, "cut", torch.int32, (nt,), dev)
    out = torch.zeros((bins.num_gaussians, len(GRAD_COLUMNS)),
                      dtype=torch.float32, device=dev)
    if nt == 0 or h == 0 or w == 0 or bins.num_gaussians == 0:
        return out
    # the work list goes by what the forward's cut left of each walk
    walk_end = _walk_end(bins, config.chunk, cut).to(torch.int32)
    work = torch.empty((nt + 1,), dtype=torch.int32, device=dev)
    fn = _build.library().splat_rasterize_train_bwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bins.tile_start.data_ptr(), bins.tile_end.data_ptr(),
                 cut.data_ptr(), walk_end.data_ptr(), work.data_ptr(),
                 work.data_ptr() + 4 * nt, feats.data_ptr(), feats.shape[1],
                 bins.ranks.data_ptr(), g_c.data_ptr(), g_lt.data_ptr(),
                 lt.data_ptr(), out.data_ptr(), h, w, config.tile_w,
                 config.tile_h, bins.tiles_x, nt, config.chunk,
                 config.alpha_clamp, config.alpha_min,
                 int(_log_cap(config) is not None),
                 int(math.isfinite(config.sigma_cutoff)), ppt, groups,
                 plan._slots(dev), plan.SPLIT_MIN_PAIRS, stream)
    _build.check(err, "rasterize_train_bwd")
    rasterize_train_bwd.launches += 1
    rasterize_train_bwd.split_tiles = work[nt:]
    return out


rasterize_train_bwd.launches = 0
graph.count_replays(rasterize_train_bwd, ("launches",))
rasterize_train_bwd.split_tiles = None


class _RasterCore(torch.autograd.Function):
    """(center_px, conic, color, opacity) -> (raw C, logT); the aux
    (depth, radius_px, visible) gets no gradient."""

    @staticmethod
    def forward(ctx, center, conic, color, opacity, depth, radius_px,
                visible, h, w, config, sat_cut_log):
        proj = ProjectedGaussians(depth=depth, center_px=center, conic=conic,
                                  radius_px=radius_px, color=color,
                                  opacity=opacity, visible=visible)
        bins = build_tile_bins(proj, h, w, config)
        c_raw, lt, cut = rasterize_train_fwd(bins, h, w, config,
                                             sat_cut_log=sat_cut_log)
        ctx.save_for_backward(color, opacity, lt)
        ctx.bins, ctx.cut, ctx.hw, ctx.config = bins, cut, (h, w), config
        return c_raw, lt

    @staticmethod
    def backward(ctx, g_c, g_lt):
        color, opacity, lt = ctx.saved_tensors
        h, w = ctx.hw
        g = rasterize_train_bwd(ctx.bins, g_c.contiguous(),
                                g_lt.contiguous(), lt, ctx.cut, h, w,
                                ctx.config)
        # rows 2-4 were taken against the prescaled conic (-a/2, -b, -c/2)
        d_conic = torch.stack([-0.5 * g[:, 2], -g[:, 3], -0.5 * g[:, 4]],
                              dim=-1)
        # the binning clips colour to [0, 1]; splat_tpu also clips opacity
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        d_color = torch.where((color >= 0.0) & (color <= 1.0), g[:, 5:8],
                              zero)
        d_opacity = torch.where((opacity >= 0.0) & (opacity <= 1.0),
                                g[:, 8], zero)
        return (g[:, 0:2], d_conic, d_color, d_opacity, None, None, None,
                None, None, None, None)


def core_from_proj(proj: ProjectedGaussians, h: int, w: int,
                   config: RenderConfig, *,
                   sat_cut_log: float = SAT_CUT_LOG):
    """Differentiable (ProjectedGaussians -> raw C (H, W, 3), logT (H, W)).
    Gradients flow to center_px, conic, color and opacity."""
    return _RasterCore.apply(proj.center_px, proj.conic, proj.color,
                             proj.opacity, proj.depth.detach(),
                             proj.radius_px.detach(), proj.visible, h, w,
                             config, sat_cut_log)


def render_tiled_diff(scene, camera, config: RenderConfig | None = None, *,
                      sat_cut_log: float = SAT_CUT_LOG) -> torch.Tensor:
    """Differentiable tiled render: the image of ``render_tiled`` without
    its 1/255 early exit, float32 (H, W, 3), or (H, W, 4) with
    config.alpha_channel.  Autograd reaches every scene tensor and the
    camera pose.  ``sat_cut_log=-inf`` turns the exact saturation cut off.
    """
    config = config or RenderConfig()
    _check_config(config)
    ss = config.supersample
    if ss > 1:
        camera = camera.scaled(ss)
    dev = scene.device
    if scene.num_gaussians == 0:
        bgc = tuple(config.background)
        if config.alpha_channel:
            bgc = bgc + (0.0,)
        return torch.tensor(bgc, dtype=torch.float32, device=dev).expand(
            camera.h // ss, camera.w // ss, len(bgc)).clone()
    proj = project_gaussians(scene, camera.to(dev), config)
    c_raw, lt = core_from_proj(proj, camera.h, camera.w, config,
                               sat_cut_log=sat_cut_log)
    return box_downsample(finish_image(c_raw, lt, config), ss)


def finish_image(c_raw, lt, config: RenderConfig) -> torch.Tensor:
    """The image from raw C and logT: clip(C + T * background), and the
    coverage 1 - T with config.alpha_channel."""
    t_n = torch.exp(lt)
    # the background as scalars: a tensor copied to the card would
    # synchronise it once per view
    t_bg = torch.stack([t_n * float(b) for b in config.background], dim=-1)
    img = torch.clamp(c_raw + t_bg, 0.0, 1.0)
    if config.alpha_channel:
        img = torch.cat([img, torch.clamp(1.0 - t_n, 0.0, 1.0)[..., None]],
                        dim=-1)
    return img

