"""Python models of what the CUDA kernels do beyond their plain versions.

The plain versions (``rasterize_tiles_plain``, ``expand_pair_keys_plain``)
say what a kernel computes; these say how ``csrc/`` computes it where that
is not obvious to be the same: a warp's strip test, a tile split across the
blocks of a cluster with their votes, the grouped walk of ``subtile_exit``,
K1's block-wise owner search.  Each
model is written as the device code is, with the sizes read from the CUDA
sources (:func:`define`).  The CPU tests hold the models against the plain
versions; the tests on the card hold the kernels against the models on the
same inputs (``tests/test_torch_cuda.py``).  Nothing on the render or
training path imports this module.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from splat_tpu_torch import _build
from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.render.binning import FEATURE_ROWS, TileBins


def define(source: str, name: str) -> int:
    """The integer ``#define name`` of ``csrc/<source>``."""
    m = re.search(rf"^#define {name} (\d+)\b",
                  (_build.CSRC / source).read_text(), re.MULTILINE)
    if m is None:
        raise KeyError(f"{source}: no integer #define {name}")
    return int(m.group(1))


# ---- csrc/raster_common.cuh: the strip test ----------------------------


def nearest_d2(c, lo, hi):
    """``nearest_d2`` in f32 numpy (fminf/fmaxf return the operand that is
    not NaN, like np.fmin/np.fmax)."""
    f = np.floor(c)
    a = np.fmin(np.fmax(f, lo), hi) - c
    b = np.fmin(np.fmax(f + np.float32(1), lo), hi) - c
    return np.fmin(a * a, b * b)


def strip_reaches(xa, xb, ya, yb, cx, cy, rx2, ry2):
    """``strip_reaches``: may some pixel of the strip [xa, xb] x [ya, yb]
    pass the box test of the pair (cx, cy, rx2, ry2)?  f32 arrays."""
    return (nearest_d2(cx, xa, xb) <= rx2) & (nearest_d2(cy, ya, yb) <= ry2)


def strip_reaches_on_card(strips, boxes):
    """The device function itself (``csrc/raster.cu::splat_strip_reaches``)
    on CUDA tensors: ``strips`` (4, n) f32 rows xa, xb, ya, yb and ``boxes``
    (4, n) f32 rows cx, cy, rx2, ry2 -> (n,) bool."""
    dev = strips.device
    n = strips.shape[1]
    for name, t in (("strips", strips), ("boxes", boxes)):
        _build.check_tensor(t, name, torch.float32, (4, n), dev)
    if dev.type != "cuda":
        raise ValueError(f"strip_reaches_on_card: unsupported device {dev}")
    out = torch.zeros((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().splat_strip_reaches(
            strips.data_ptr(), boxes.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "strip_reaches")
    return out.bool()


# ---- csrc/raster.cu: a tile split across a cluster ---------------------


def saturating_frame(chunk: int, alpha_channel: bool, counts=(300, 250),
                     fade: int = 150, fade_opacity: float = 0.6,
                     c2: float = -0.01, h: int = 30, device="cpu"):
    """Two 32x32 tiles of an h x 50 image (pixels past the edge vote too),
    built by hand so that the tiles exit before their last batch and their
    pixel groups saturate at different batches: ``counts`` pairs a tile;
    splats centred above the tile that fade downwards (the top rows
    saturate first), then, from pair ``fade`` of a tile on, flat splats of
    alpha 0.5 and random colour that cover every pixel.  Returns (bins, h,
    w, config)."""
    rng = np.random.default_rng(7)
    w = 50
    n = sum(counts)
    feats = np.zeros((len(FEATURE_ROWS), n), np.float32)
    k = 0
    for t, c in enumerate(counts):
        flat = np.arange(c) >= fade
        feats[0, k:k + c] = 32 * t + rng.uniform(0, 32, c)         # cx
        feats[1, k:k + c] = -5.0                                    # cy
        feats[2, k:k + c] = np.where(flat, 0.0, -1e-4)              # a2
        feats[4, k:k + c] = np.where(flat, 0.0, c2)                 # c2
        feats[5:8, k:k + c] = rng.uniform(0, 1, (3, c))
        feats[8, k:k + c] = np.where(flat, 0.5, fade_opacity)
        k += c
    feats[9:11] = np.inf
    edges = np.cumsum((0,) + tuple(counts)).astype(np.int32)
    dev = torch.device(device)
    bins = TileBins(features=torch.from_numpy(feats).to(dev),
                    tile_start=torch.from_numpy(edges[:-1].copy()).to(dev),
                    tile_end=torch.from_numpy(edges[1:].copy()).to(dev),
                    ranks=torch.arange(n, device=dev),
                    num_pairs=torch.tensor(n, device=dev),
                    overflow=torch.tensor(0, device=dev), tiles_x=2,
                    tiles_y=1, num_gaussians=n)
    cfg = RenderConfig(chunk=chunk, alpha_channel=alpha_channel,
                       sigma_cutoff=math.inf, background=(0.1, 0.3, 0.5))
    return bins, h, w, cfg


def split_composite(bins: TileBins, h: int, w: int, cfg: RenderConfig,
                    groups: int = 4):
    """K2 as ``raster_walk<P, true>`` runs a split tile (sigma_cutoff=inf,
    CPU tensors): each of ``groups`` blocks composites its own share of the
    tile's pixel slots over the same batches; after every batch each block
    votes whether any of its pixels still has T >= alpha_min, and the tile
    stops when no block votes to go on.  Returns the image, the pairs
    walked per tile, and per tile the first batch after which each group
    voted to stop (-1: never)."""
    tw, th, chunk = cfg.tile_w, cfg.tile_h, cfg.chunk
    npix = tw * th
    per = npix // groups
    nchan = 4 if cfg.alpha_channel else 3
    img = torch.zeros((bins.tiles_y * th, bins.tiles_x * tw, nchan))
    walked = torch.zeros(bins.tiles_x * bins.tiles_y, dtype=torch.int64)
    stopped = []
    f = bins.features
    bg = torch.tensor(cfg.background)
    for t in range(walked.numel()):
        s, e = int(bins.tile_start[t]), int(bins.tile_end[t])
        x0, y0 = (t % bins.tiles_x) * tw, (t // bins.tiles_x) * th
        slots = [torch.arange(g * per, (g + 1) * per) for g in range(groups)]
        px = [(x0 + p % tw).float() for p in slots]
        py = [(y0 + p // tw).float() for p in slots]
        col = [torch.zeros((per, 3)) for _ in range(groups)]
        tr = [torch.ones(per) for _ in range(groups)]
        first_stop = [-1] * groups
        end = s
        for batch, kb in enumerate(range(s - s % chunk, e, chunk)):
            end = min(e, kb + chunk)
            votes = []
            for g in range(groups):
                for k in range(max(s, kb), end):
                    cx, cy, a2, b2, c2, r, gg, b, op = f[:9, k]
                    dx = px[g] - cx
                    dy = cy - py[g]
                    power = a2 * (dx * dx) + c2 * (dy * dy) + b2 * (dx * dy)
                    alpha = torch.clamp(op * torch.exp(power),
                                        max=cfg.alpha_clamp)
                    keep = alpha >= cfg.alpha_min
                    wgt = (alpha * tr[g])[:, None]
                    col[g] = torch.where(keep[:, None], col[g] + wgt
                                         * torch.stack([r, gg, b]), col[g])
                    tr[g] = torch.where(keep, tr[g] * (1.0 - alpha), tr[g])
                votes.append(bool(tr[g].max() >= cfg.alpha_min))
                if not votes[g] and first_stop[g] < 0:
                    first_stop[g] = batch
            if not any(votes):
                break
        walked[t] = max(end - s, 0)
        stopped.append(first_stop)
        c_all, t_all = torch.cat(col), torch.cat(tr)
        out = [torch.clamp(c_all + t_all[:, None] * bg, 0.0, 1.0)]
        if cfg.alpha_channel:
            out.append(torch.clamp(1.0 - t_all, 0.0, 1.0)[:, None])
        img[y0:y0 + th, x0:x0 + tw] = torch.cat(out, 1).reshape(th, tw, nchan)
    return img[:h, :w], walked, stopped


# ---- csrc/raster.cu: subtile_exit's grouped walk ------------------------


def group_layout(tile_w: int, tile_h: int):
    """``slot_xy<true>``: the (x, y) in the tile of every pixel slot of the
    group-by-group layout, (tile_w * tile_h,) int64 each."""
    gw, gh = define("raster.cu", "GROUP_W"), define("raster.cu", "GROUP_H")
    p = torch.arange(tile_w * tile_h)
    g, q = p // (gw * gh), p % (gw * gh)
    cols = tile_w // gw
    return (g % cols) * gw + q % gw, (g // cols) * gh + q // gw


def group_strip(pa: int, pb: int, tile_w: int):
    """``group_strip``: the rectangle (xa, xb, ya, yb), in tile pixels, that
    the kernel tests a warp's pairs against for its slots [pa, pb] of the
    grouped layout."""
    gw, gh = define("raster.cu", "GROUP_W"), define("raster.cu", "GROUP_H")
    gp, cols = gw * gh, tile_w // gw
    ga, gb = pa // gp, pb // gp
    gxa, gya = ga % cols, ga // cols
    if ga == gb:
        ra, rb = (pa % gp) // gw, (pb % gp) // gw
        return (gxa * gw + (pa % gw if ra == rb else 0),
                gxa * gw + (pb % gw if ra == rb else gw - 1),
                gya * gh + ra, gya * gh + rb)
    if gya == gb // cols:
        return (gxa * gw, (gb % cols) * gw + gw - 1, gya * gh,
                gya * gh + gh - 1)
    return 0, tile_w - 1, gya * gh, (gb // cols) * gh + gh - 1


def grouped_composite(bins: TileBins, h: int, w: int, cfg: RenderConfig,
                      ppt: int, blocks: int):
    """K2 as ``raster_walk<ppt, _, true>`` runs every tile on the grouped
    walk (CPU tensors; every tile treated as heavy): ``blocks`` blocks a
    tile, each of 256 threads with ``ppt`` pixel slots of the grouped layout
    a thread (lane l of warp v holds slots base + 32 * (v * ppt + i) + l).
    A warp tests each staged pair against its strip (with a finite
    sigma_cutoff) and composites it at the pixels of its live groups; after
    every batch each group whose pixels all have T < alpha_min /
    2^GROUP_STOP_SHIFT stops, and the tile ends, as the blocks' votes decide,
    once every pixel has T < alpha_min.  Returns the image and the (T, G)
    pairs each group walked."""
    threads = define("raster_common.cuh", "THREADS")
    gp = define("raster.cu", "GROUP_W") * define("raster.cu", "GROUP_H")
    gstop = cfg.alpha_min / 2 ** define("raster.cu", "GROUP_STOP_SHIFT")
    tw, th, chunk = cfg.tile_w, cfg.tile_h, cfg.chunk
    npix = tw * th
    ng = npix // gp
    use_bbox = math.isfinite(cfg.sigma_cutoff)
    nchan = 4 if cfg.alpha_channel else 3
    nt = bins.tiles_x * bins.tiles_y
    img = torch.zeros((bins.tiles_y * th, bins.tiles_x * tw, nchan))
    group_walked = torch.zeros((nt, ng), dtype=torch.int64)
    lx, ly = group_layout(tw, th)
    f = bins.features
    bg = torch.tensor(cfg.background)
    slots = torch.arange(npix)
    grp = slots // gp
    # each slot's warp over the tile's blocks, and each warp's strip
    per_block = threads * ppt
    warp = (slots // per_block) * (threads // 32) + (
        slots % per_block) // (32 * ppt)
    for t in range(nt):
        s, e = int(bins.tile_start[t]), int(bins.tile_end[t])
        x0, y0 = (t % bins.tiles_x) * tw, (t // bins.tiles_x) * th
        px, py = (x0 + lx).float(), (y0 + ly).float()
        rects = {}
        for v in warp.unique().tolist():
            b, vb = divmod(v, threads // 32)
            pa = b * per_block + vb * 32 * ppt
            xa, xb, ya, yb = group_strip(pa, min(pa + 32 * ppt, npix) - 1,
                                         tw)
            rects[v] = np.float32([x0 + xa, x0 + xb, y0 + ya, y0 + yb])
        col = torch.zeros((npix, 3))
        tr = torch.ones(npix)
        live = torch.ones(ng, dtype=torch.bool)
        for kb in range(s - s % chunk, e, chunk):
            group_walked[t, live] = min(e, kb + chunk) - s
            for k in range(max(s, kb), min(e, kb + chunk)):
                cx, cy, a2, b2, c2, r, gg, bb, op, rx2, ry2 = f[:, k]
                reach = torch.ones(npix, dtype=torch.bool)
                if use_bbox:
                    ok = {v: bool(strip_reaches(
                        *rc, *np.float32([cx, cy, rx2, ry2])))
                        for v, rc in rects.items()}
                    reach = torch.tensor([ok[v] for v in warp.tolist()])
                dx = px - cx
                dy = cy - py
                dx2, dy2 = dx * dx, dy * dy
                power = a2 * dx2 + c2 * dy2 + b2 * (dx * dy)
                alpha = torch.clamp(op * torch.exp(power),
                                    max=cfg.alpha_clamp)
                keep = (alpha >= cfg.alpha_min) & live[grp] & reach
                if use_bbox:
                    keep = keep & (dx2 <= rx2) & (dy2 <= ry2)
                wgt = (alpha * tr)[:, None]
                col = torch.where(keep[:, None],
                                  col + wgt * torch.stack([r, gg, bb]), col)
                tr = torch.where(keep, tr * (1.0 - alpha), tr)
            gmax = torch.zeros(ng).scatter_reduce_(0, grp, tr, "amax",
                                                   include_self=False)
            live = live & (gmax >= gstop)
            if not bool((tr >= cfg.alpha_min).any()):
                break
        out = [torch.clamp(col + tr[:, None] * bg, 0.0, 1.0)]
        if cfg.alpha_channel:
            out.append(torch.clamp(1.0 - tr, 0.0, 1.0)[:, None])
        tile = torch.zeros((th, tw, nchan))
        tile[ly, lx] = torch.cat(out, 1)
        img[y0:y0 + th, x0:x0 + tw] = tile
    return img[:h, :w], group_walked


# ---- csrc/expand.cu: K1's block-wise owner search ----------------------


def multiway_upper_bound(first, k: int, ways: int):
    """The search for a block's first and last owner: ``ways`` probes a
    round, spread over [lo, hi); the probes at or below k are a prefix, and
    their count narrows the range.  Returns the first g with first[g] > k
    (len(first) if none) and the rounds taken."""
    lo, hi, rounds = 0, len(first), 0
    while hi > lo:
        step = -(-(hi - lo) // ways)
        probes = lo + (np.arange(ways) + 1) * step - 1
        below = (probes < hi) & (first[np.minimum(probes, hi - 1)] <= k)
        c = int(below.sum())
        if not bool(below[:c].all()):
            raise AssertionError("probes at or below k are not a prefix")
        hi = min(hi, lo + (c + 1) * step - 1)
        lo = min(lo + c * step, hi)
        rounds += 1
    return lo, rounds


def expand_by_blocks(first, tx0, ty0, sw, dbits, total: int, k_cap: int,
                     ntx: int, nt: int, slots_per_block: int | None = None,
                     stage_cap: int | None = None, ways: int | None = None):
    """K1 as ``expand_pairs_kernel`` computes it (numpy arrays): each block
    takes ``slots_per_block`` consecutive slots, finds the owners of its
    first and last filled slot, and searches every slot within that range:
    in a staged copy relative to its first slot where the range fits
    ``stage_cap`` entries, else in ``first`` itself.  The sizes default to
    those of ``csrc/expand.cu``.  Returns keys, owners (int64 arrays) and
    the number of blocks that took each path."""
    if slots_per_block is None:
        slots_per_block = define("expand.cu", "SLOTS_PER_BLOCK")
    if stage_cap is None:
        stage_cap = define("expand.cu", "STAGE_CAP")
    if ways is None:
        ways = define("expand.cu", "THREADS") // 2
    keys = np.full(k_cap, nt << 32, np.int64)
    owners = np.zeros(k_cap, np.int64)
    filled = min(total, k_cap)
    staged_blocks = direct_blocks = 0
    for k0 in range(0, k_cap, slots_per_block):
        kfill = min(k0 + slots_per_block, filled)
        if kfill <= k0:
            continue                        # sentinel slots only
        g_lo = multiway_upper_bound(first, k0, ways)[0] - 1
        g_end = multiway_upper_bound(first, kfill - 1, ways)[0]
        k = np.arange(k0, kfill)
        if g_end - g_lo <= stage_cap:
            rel = (first[g_lo:g_end] - k0).astype(np.int32)
            if not np.array_equal(rel.astype(np.int64),
                                  first[g_lo:g_end] - k0):
                raise AssertionError("staged offset does not fit int32")
            q = np.searchsorted(rel, (k - k0).astype(np.int32),
                                side="right") - 1
            g, start = g_lo + q, k0 + rel[q].astype(np.int64)
            staged_blocks += 1
        else:
            g = g_lo + np.searchsorted(first[g_lo:g_end], k,
                                       side="right") - 1
            start = first[g]
            direct_blocks += 1
        r = k - start
        tile = (ty0[g] + r // sw[g]).astype(np.int64) * ntx + tx0[g] \
            + r % sw[g]
        keys[k0:kfill] = (tile << 32) | (dbits[g].astype(np.int64)
                                         & 0xFFFFFFFF)
        owners[k0:kfill] = g
    return keys, owners, staged_blocks, direct_blocks
