"""Per-tile front-to-back alpha compositing (K2).

Port of ``splat_tpu/render/kernels.py::rasterize_tiles``.  Each tile walks
its sorted pair range [start, end) front to back.  For each (pixel, pair):
dx = px - cx, dy = cy - py (integer pixel coordinates, local +y up),
power = a2*dx^2 + c2*dy^2 + b2*dx*dy, alpha = min(alpha_clamp,
op*exp(power)); the pair is kept if alpha >= alpha_min and, unless
sigma_cutoff is inf, the pixel is inside the quantized bbox.  Kept pairs
composite C += alpha*T*color, T *= 1 - alpha.  After each batch of
``chunk`` pairs (batches start at absolute multiples of ``chunk`` in the
sorted array) the whole tile stops once every one of its pixels has
T < alpha_min.  Output: clip(C + T*background) plus clip(1 - T) with
alpha_channel, as (H, W, C).

With ``subtile_exit`` a heavy tile (more than ``subtile_heavy_pairs``
pairs) whose pixels divide into :func:`group_grid`'s 8 x 16 groups also
exits per group: after each batch, each group whose pixels all have
T < alpha_min / 2^GROUP_STOP_SHIFT stops compositing, and the tile ends
where the whole-tile rule ends it.  A pixel's C and T then differ from the
whole-tile walk's only by what it would have composited after its group
stopped, less than its T: under 1e-6 at the default alpha_min.

The card runs the hand-written kernel ``csrc/raster.cu``, which splits
heavy tiles by pixels across the blocks of a cluster (the work list of
``render/plan.py``, built on the card just before the launch) and lets
each warp skip the pairs whose box misses its pixel strip; CPU tensors take :func:`rasterize_tiles_plain`, which performs
the same float operations in the same order, so the two differ only where
the libraries' rounding does.  On a grouped tile the kernel lays the pixels
out group by group, so that a warp holds whole groups (or, at fewer than 4
pixels a thread, a share of one) and skips the pairs of its stopped groups
while the block goes on staging batches for the others.
The TPU kernel's prefix-product/MXU machinery is not ported, nor is the
phase compaction it runs ``subtile_exit`` as (groups checked every 8
windows, the last 4 live ones compacted and walked on until all have
T < alpha_min, so its image may leave the whole-tile one by up to
alpha_min): the card checks each group after every batch, against the
lower threshold.
"""

from __future__ import annotations

import math

import torch

from splat_tpu_torch import _build
from splat_tpu_torch.config import RenderConfig, check_kernel_limits
from splat_tpu_torch.render.binning import FEATURE_DIM, TileBins
from splat_tpu_torch.render import plan
from splat_tpu_torch.render.plan import THREADS

# pixels per thread the kernels are instantiated for
_PPT = (1, 2, 4, 8, 16)
# subtile_exit's pixel groups (csrc/raster.cu's GROUP_W, GROUP_H), as in
# splat_tpu/render/kernels.py
GROUP_W = 16
GROUP_H = 8
# a group stops once all its pixels have T < alpha_min / 2**GROUP_STOP_SHIFT
# (csrc/raster.cu's GROUP_STOP_SHIFT)
GROUP_STOP_SHIFT = 12


def group_grid(tile_w: int, tile_h: int, subtile: bool):
    """(GY, GX): a tile's rows and columns of 8 x 16 pixel groups, or None
    where the tile keeps the whole-tile exit (subtile off, a tile that does
    not divide into groups, or one group), as ``splat_tpu``'s
    ``group_grid`` degrades."""
    if (subtile and tile_w % GROUP_W == 0 and tile_h % GROUP_H == 0
            and tile_w * tile_h > GROUP_W * GROUP_H):
        return tile_h // GROUP_H, tile_w // GROUP_W
    return None


def _ppt(config: RenderConfig) -> tuple[int, int]:
    """(pixels per thread, blocks per tile) for the config's tile: one
    block for a tile of at most 16 x 256 pixels, else one block of 16 a
    thread per pixel group (the limits RenderConfig enforces, checked again:
    the kernels trust them)."""
    check_kernel_limits(config.tile_w, config.tile_h, config.chunk)
    p = config.tile_w * config.tile_h
    groups = -(-p // (_PPT[-1] * THREADS))
    if groups > 1:
        return _PPT[-1], groups
    return next(q for q in _PPT if q * THREADS >= p), 1


def _untile(x, nty: int, ntx: int, th: int, tw: int, h: int, w: int):
    """(T, P, ...) per-tile pixels -> (H, W, ...) image."""
    rest = x.shape[2:]
    img = x.reshape(nty, ntx, th, tw, *rest).transpose(1, 2)
    return img.reshape(nty * th, ntx * tw, *rest)[:h, :w]


def rasterize_tiles_plain(bins: TileBins, h: int, w: int,
                          config: RenderConfig, *,
                          return_walked: bool = False,
                          return_group_walked: bool = False):
    """Plain PyTorch version of the K2 kernel (any device): all tiles step
    through their batches together, each batch composited pair by pair.

    return_walked: also return the (T,) int64 number of pairs each tile
    walked before its exit (the work the kernel does on these inputs).
    return_group_walked: also return (after it) the (T, G) int64 pairs each
    of a tile's G pixel groups composited before it stopped (G = 1, the
    whole tile, where :func:`group_grid` gives none; a tile on the
    whole-tile exit walks each group as far as the tile)."""
    tw, th = config.tile_w, config.tile_h
    ntx, nty = bins.tiles_x, bins.tiles_y
    nt, p, chunk = ntx * nty, tw * th, config.chunk
    feats = bins.features
    dev = feats.device
    kp = feats.shape[1]
    use_bbox = math.isfinite(config.sigma_cutoff)

    s = bins.tile_start.to(torch.int64)
    e = bins.tile_end.to(torch.int64)
    base = s - s % chunk
    nb = torch.where(e > base, (e - base + chunk - 1) // chunk,
                     torch.zeros_like(e))
    lin = torch.arange(p, device=dev)
    tid = torch.arange(nt, device=dev)
    pxf = ((tid % ntx)[:, None] * tw + lin % tw).to(torch.float32)  # (T, P)
    pyf = ((tid // ntx)[:, None] * th + lin // tw).to(torch.float32)
    color = torch.zeros((nt, p, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((nt, p), dtype=torch.float32, device=dev)
    alive = torch.ones(nt, dtype=torch.bool, device=dev)
    batches = torch.zeros(nt, dtype=torch.int64, device=dev)
    lane = torch.arange(chunk, device=dev)
    grid = group_grid(tw, th, config.subtile_exit)
    gy_n, gx_n = grid or (1, 1)
    ng = gy_n * gx_n
    # each pixel's group; which tiles exit per group; which groups go on
    gid = (lin // tw // GROUP_H) * gx_n + (lin % tw) // GROUP_W
    heavy = ((e - s > config.subtile_heavy_pairs) if grid
             else torch.zeros(nt, dtype=torch.bool, device=dev))
    glive = torch.ones((nt, ng), dtype=torch.bool, device=dev)
    group_stop = config.alpha_min / 2 ** GROUP_STOP_SHIFT
    gbatches = torch.zeros((nt, ng), dtype=torch.int64, device=dev)

    for j in range(int(nb.max()) if nt else 0):
        act = torch.nonzero(alive & (nb > j)).flatten()
        if act.numel() == 0:
            break
        k = base[act, None] + j * chunk + lane               # (A, chunk)
        valid = (k >= s[act, None]) & (k < e[act, None])
        f = feats[:, k.clamp(0, max(kp - 1, 0))]             # (F, A, chunk)
        px, py = pxf[act], pyf[act]
        c_a, t_a = color[act], trans[act]
        g_on = glive[act]
        live = g_on[:, gid] if grid else None              # (A, P)
        for i in range(chunk):
            v = valid[:, i]
            if not bool(v.any()):
                continue
            cx, cy, a2, b2, c2, r, g, b, op, rx2, ry2 = (
                f[q, :, i, None] for q in range(FEATURE_DIM))
            dx = px - cx
            dy = cy - py
            dx2 = dx * dx
            dy2 = dy * dy
            power = a2 * dx2 + c2 * dy2 + b2 * (dx * dy)
            alpha = torch.clamp(op * torch.exp(power), max=config.alpha_clamp)
            keep = (alpha >= config.alpha_min) & v[:, None]
            if use_bbox:
                keep = keep & (dx2 <= rx2) & (dy2 <= ry2)
            if grid:
                keep = keep & live
            wgt = (alpha * t_a)[..., None]
            rgb = torch.stack([r, g, b], dim=-1)              # (A, 1, 3)
            c_a = torch.where(keep[..., None], c_a + wgt * rgb, c_a)
            t_a = torch.where(keep, t_a * (1.0 - alpha), t_a)
        color[act] = c_a
        trans[act] = t_a
        alive[act] = t_a.amax(dim=1) >= config.alpha_min
        batches[act] = j + 1
        gbatches[act] += g_on
        if grid:
            gmax = t_a.reshape(-1, gy_n, GROUP_H, gx_n, GROUP_W).amax(
                dim=(2, 4)).reshape(-1, ng)
            glive[act] = torch.where(heavy[act, None],
                                     g_on & (gmax >= group_stop), g_on)

    bg = torch.tensor(config.background, dtype=torch.float32, device=dev)
    out = [torch.clamp(color + trans[..., None] * bg, 0.0, 1.0)]
    if config.alpha_channel:
        out.append(torch.clamp(1.0 - trans, 0.0, 1.0)[..., None])
    img = _untile(torch.cat(out, dim=-1), nty, ntx, th, tw, h, w)
    res = [img]
    if return_walked:
        res.append(torch.clamp(torch.minimum(e, base + batches * chunk) - s,
                               min=0))
    if return_group_walked:
        res.append(torch.clamp(torch.minimum(
            e[:, None], base[:, None] + gbatches * chunk) - s[:, None],
            min=0))
    return res[0] if len(res) == 1 else tuple(res)


def rasterize_tiles(bins: TileBins, h: int, w: int,
                    config: RenderConfig) -> torch.Tensor:
    """Composite the binned pairs.  Returns float32 (H, W, 3) in [0, 1], or
    (H, W, 4) with config.alpha_channel (RGB + accumulated 1 - T).

    CUDA tensors launch ``csrc/raster.cu`` (or raise); CPU tensors take
    :func:`rasterize_tiles_plain`.
    """
    feats = bins.features
    dev = feats.device
    if dev.type == "cpu":
        return rasterize_tiles_plain(bins, h, w, config)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_tiles: unsupported device {dev}")
    tw, th = config.tile_w, config.tile_h
    nt = bins.tiles_x * bins.tiles_y
    ppt, groups = _ppt(config)
    if bins.tiles_x * tw < w or bins.tiles_y * th < h:
        raise ValueError("tile grid does not cover the image")
    if feats.dim() != 2 or feats.shape[1] >= 1 << 31:
        raise ValueError(f"features: need ({FEATURE_DIM}, K < 2^31), got "
                         f"{tuple(feats.shape)}")
    _build.check_tensor(feats, "features", torch.float32,
                        (FEATURE_DIM, feats.shape[1]), dev)
    for name, t in (("tile_start", bins.tile_start),
                    ("tile_end", bins.tile_end)):
        _build.check_tensor(t, name, torch.int32, (nt,), dev)
    nchan = 4 if config.alpha_channel else 3
    out = torch.empty((h, w, nchan), dtype=torch.float32, device=dev)
    if nt == 0 or h == 0 or w == 0:
        return out
    bg = [float(c) for c in config.background]
    # subtile_exit: the tile's groups in a row (0: every tile whole)
    grid = group_grid(tw, th, config.subtile_exit)
    group_cols = grid[1] if grid else 0
    heavy_pairs = min(config.subtile_heavy_pairs, (1 << 31) - 1)
    # the launch's work list, built on the card: tile ids, then the count
    # of split tiles
    work = torch.empty((nt + 1,), dtype=torch.int32, device=dev)
    fn = _build.library().splat_rasterize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bins.tile_start.data_ptr(), bins.tile_end.data_ptr(),
                 work.data_ptr(), work.data_ptr() + 4 * nt,
                 feats.data_ptr(), feats.shape[1], out.data_ptr(), h, w, tw,
                 th, bins.tiles_x, nt, config.chunk, config.alpha_clamp,
                 config.alpha_min, bg[0], bg[1], bg[2], nchan,
                 int(math.isfinite(config.sigma_cutoff)), ppt, groups,
                 plan._slots(dev), plan.SPLIT_MIN_PAIRS, group_cols,
                 heavy_pairs, stream)
    _build.check(err, "rasterize_tiles")
    rasterize_tiles.launches += 1
    if group_cols:
        rasterize_tiles.subtile_launches += 1
    rasterize_tiles.split_tiles = work[nt:]
    rasterize_tiles.tile_order = work[:nt]
    return out


rasterize_tiles.launches = 0
# of those, the launches of the variant with the per-group exit
rasterize_tiles.subtile_launches = 0
# the last launch's count of split tiles, a (1,) int32 tensor on the card
rasterize_tiles.split_tiles = None
# and the order in which its blocks took the tiles, (T,) int32
rasterize_tiles.tile_order = None
