"""The compositing kernel's (K2) plain version held against splat_tpu's
Pallas raster kernel in interpret mode on the SAME pair lists: the JAX
binning's packed feature table is decoded into the port's f32 rows (CPU)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import splat_tpu as st
from splat_tpu.ops.projection import project_gaussians as jax_project
from splat_tpu.render.binning import _R15_MAX
from splat_tpu.render.binning import build_tile_bins as jax_bins
from splat_tpu.render.kernels import rasterize_tiles as jax_raster
from splat_tpu_torch import RenderConfig
from splat_tpu_torch.render import emulate
from splat_tpu_torch.render.binning import FEATURE_ROWS, TileBins
from splat_tpu_torch.render.kernels import (GROUP_H, GROUP_STOP_SHIFT,
                                            GROUP_W, group_grid,
                                            rasterize_tiles_plain)
from splat_tpu_torch.utils.image import psnr

torch.set_num_threads(1)

H, W = 80, 112          # not multiples of the 32-px tile: edge tiles


def _port_bins(jb) -> TileBins:
    """The port's f32 feature rows decoded from the JAX packed table
    exactly as the Pallas kernel decodes them (splat_tpu kernels.py)."""
    f = np.asarray(jb.features)
    frow = lambda i: f[i].view(np.float32)
    inv = np.float32(1.0 / 65535.0)
    lo = lambda i: (f[i] & 0xFFFF).astype(np.float32) * inv
    hi = lambda i: ((f[i] >> 16) & 0xFFFF).astype(np.float32) * inv
    rxq, ryq = f[7] & 0x7FFF, (f[7] >> 15) & 0x7FFF
    rx = rxq.astype(np.float32) * np.float32(0.125)
    ry = ryq.astype(np.float32) * np.float32(0.125)
    rows = [frow(0), frow(1), frow(2), frow(3), frow(4), lo(5), hi(5), lo(6),
            hi(6), np.where(rxq == _R15_MAX, np.inf, rx * rx),
            np.where(ryq == _R15_MAX, np.inf, ry * ry)]
    feats = torch.from_numpy(np.stack(rows).astype(np.float32))
    return TileBins(features=feats,
                    tile_start=torch.tensor(np.asarray(jb.tile_start)),
                    tile_end=torch.tensor(np.asarray(jb.tile_end)),
                    ranks=torch.tensor(np.asarray(jb.ranks)).long(),
                    num_pairs=torch.tensor(int(jb.num_pairs)),
                    overflow=torch.tensor(int(jb.overflow)),
                    tiles_x=jb.tiles_x, tiles_y=jb.tiles_y,
                    num_gaussians=int(np.asarray(jb.ranks).max()) + 1)


@pytest.mark.parametrize("cfg_kw", [
    dict(chunk=64),
    dict(chunk=64, alpha_channel=True, background=(0.2, 0.4, 0.9),
         sigma_cutoff=math.inf),
], ids=["default", "rgba_bg_sigma_inf"])
def test_raster_plain_matches_pallas_kernel(cfg_kw):
    scene = st.random_scene(1200, seed=21, extent=1.5,
                            scale_range=(0.02, 0.15))
    cam = st.Camera.create(h=H, w=W, position=(0.0, 0.0, 3.5), yaw=0.2)
    jcfg = st.RenderConfig(**cfg_kw)
    jb = jax_bins(jax_project(scene, cam, jcfg), H, W, jcfg)
    assert int(jb.num_pairs) > 0
    want = np.asarray(jax_raster(jb, H, W, jcfg, interpret=True))
    got = rasterize_tiles_plain(_port_bins(jb), H, W, RenderConfig(**cfg_kw))
    assert got.shape == want.shape == (H, W, 4 if "alpha_channel" in cfg_kw
                                       else 3)
    # same pairs, same whole-tile exit points: only the TPU kernel's
    # log-space prefix product differs from the serial product
    assert psnr(got.numpy(), want) >= 60.0


@pytest.mark.parametrize("chunk,want", [(2, 0.0), (4, 0.0035 * 0.99)])
def test_whole_tile_exit_is_batch_granular(chunk, want):
    # three flat splats (zero conic: alpha = opacity at every pixel) over
    # one 32x32 tile of a 20x24 image.  After the first two, T = 0.01 *
    # 0.35 < alpha_min at every pixel, so the third (white) is composited
    # only when it shares their batch.
    n = 3
    feats = torch.zeros((len(FEATURE_ROWS), n))
    feats[0:2] = 10.0
    feats[5:8, 2] = 1.0
    feats[8] = torch.tensor([0.99, 0.65, 0.99])
    feats[9:11] = math.inf
    bins = TileBins(features=feats,
                    tile_start=torch.tensor([0], dtype=torch.int32),
                    tile_end=torch.tensor([n], dtype=torch.int32),
                    ranks=torch.arange(n), num_pairs=torch.tensor(n),
                    overflow=torch.tensor(0), tiles_x=1, tiles_y=1,
                    num_gaussians=n)
    img = rasterize_tiles_plain(bins, 20, 24, RenderConfig(chunk=chunk))
    assert img.shape == (20, 24, 3)
    np.testing.assert_allclose(img.numpy(), want, atol=1e-6)


# ---- the kernel's design: its Python models (render/emulate.py), which
# ---- the tests on the card hold the kernels against ---------------------


@pytest.mark.parametrize("alpha_channel", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("chunk", [64, 128])
def test_split_tile_composite_equals_unsplit(chunk, alpha_channel):
    bins, h, w, cfg = emulate.saturating_frame(chunk, alpha_channel)
    want, walked = rasterize_tiles_plain(bins, h, w, cfg, return_walked=True)
    pairs = (bins.tile_end - bins.tile_start).long()
    assert bool((walked < pairs).all())           # exits before the end
    got, got_walked, stopped = emulate.split_composite(bins, h, w, cfg)
    assert torch.equal(got_walked, walked)
    # the pixel groups saturate at different batches: the votes matter
    assert all(len(set(s)) > 1 and min(s) >= 0 for s in stopped)
    # the same f32 operations per pixel, in the same order
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_strip_skip_drops_only_pairs_no_pixel_keeps(seed):
    rng = np.random.default_rng(seed)
    n = 4000
    f32 = np.float32
    # strips: one tile row segment, a few rows, or a whole 32x32 tile
    xa = rng.integers(0, 200, n)
    ya = rng.integers(0, 200, n)
    xb = xa + rng.choice([0, 7, 15, 31], n)
    yb = ya + rng.choice([0, 0, 3, 7, 31], n)
    cx = (xa + rng.uniform(-40, 72, n)).astype(f32)
    cy = (ya + rng.uniform(-40, 72, n)).astype(f32)
    # centres on pixel centres and on the boundaries between pixels
    snap = rng.integers(0, 4, n)
    cx = np.where(snap == 1, np.round(cx), np.where(
        snap == 2, np.floor(cx) + f32(0.5), cx)).astype(f32)
    cy = np.where(snap == 1, np.round(cy), np.where(
        snap == 2, np.floor(cy) + f32(0.5), cy)).astype(f32)
    r = (rng.integers(0, 400, (2, n)) * 0.125).astype(f32)  # 1/8-px radii
    rx2, ry2 = r[0] * r[0], r[1] * r[1]
    rx2[rng.random(n) < 0.1] = np.inf                      # saturated
    ry2[rng.random(n) < 0.1] = np.inf
    nan = rng.random(n) < 0.05
    cx[nan] = np.nan
    cy[nan & (rng.random(n) < 0.5)] = np.nan
    with np.errstate(invalid="ignore"):
        reach = emulate.strip_reaches(xa.astype(f32), xb.astype(f32),
                                      ya.astype(f32), yb.astype(f32), cx, cy,
                                      rx2, ry2)
        kept_any = np.zeros(n, bool)
        for i in range(n):
            px = np.arange(xa[i], xb[i] + 1, dtype=f32)
            py = np.arange(ya[i], yb[i] + 1, dtype=f32)
            dx, dy = px - cx[i], cy[i] - py        # the plain version's test
            kept_any[i] = ((dx * dx <= rx2[i]).any()
                           and (dy * dy <= ry2[i]).any())
    # never skipped where some pixel passes the box test; and on a
    # rectangle the test is exact, so it skips whenever it may
    assert not (kept_any & ~reach).any()
    assert not (reach & ~kept_any).any()
    assert not reach[nan].any()
    assert 0.05 < reach.mean() < 0.95


@pytest.mark.parametrize("ppt", [1, 2, 4, 8])
def test_raster_plan_covers_each_pixel_once(ppt):
    """K2 plans on the pairs a tile holds (an upper bound of its walk); the
    blocks of its launch take every pixel slot of every tile once."""
    from splat_tpu_torch.render import plan

    rng = np.random.default_rng(ppt)
    start = torch.tensor(np.cumsum(rng.integers(0, 3 * plan.SPLIT_MIN_PAIRS,
                                                61)), dtype=torch.int32)
    pairs = (start[1:] - start[:-1]).long()        # tile_end - tile_start
    split = plan._split(ppt)
    order, nheavy = plan._tile_plan(pairs, split, slots=40)
    key = plan._plan_keys(pairs, split, slots=40)
    cap = max(plan.SPLIT_MIN_PAIRS, int(pairs.sum()) // 40)
    heavy = pairs > cap if split > 1 else torch.zeros_like(pairs, dtype=bool)
    assert int(nheavy) == int(heavy.sum())
    assert (ppt == 1) == (int(nheavy) == 0)
    assert sorted(order.tolist()) == list(range(60))
    assert set(order[:int(nheavy)].tolist()) == set(
        torch.nonzero(heavy).flatten().tolist())
    assert bool((key[order.long()][1:] >= key[order.long()][:-1]).all())
    # longest first to within a bucket of max / PLAN_BUCKETS pairs
    light = pairs[order.long()][int(nheavy):]
    assert bool((light[1:] <= light[:-1] + int(pairs.max())
                 // (plan.PLAN_BUCKETS - 1) + 1).all())
    seen = torch.zeros((60, ppt * plan.THREADS), dtype=torch.int32)
    for tile, group, groups in plan._block_work(order, nheavy, split):
        per = ppt * plan.THREADS // groups
        seen[tile, group * per:(group + 1) * per] += 1
        assert (groups > 1) == bool(heavy[tile])
    assert bool((seen == 1).all())


def test_plan_names_still_import_from_diff():
    from splat_tpu_torch.render import diff, kernels, plan

    for name in ("_tile_plan", "_split", "_slots", "_block_work",
                 "SPLIT_MIN_PAIRS", "SPLIT_BLOCKS", "BLOCKS_PER_SM"):
        assert getattr(diff, name) is getattr(plan, name), name
    assert kernels.THREADS == plan.THREADS == diff.THREADS == 256
    # a balanced frame splits nothing; one tile far above the rest is split
    walk = torch.full((2040,), 990)
    assert int(plan._tile_plan(walk, 4, slots=264)[1]) == 0
    walk[7] = 43502
    order, nheavy = plan._tile_plan(walk, 4, slots=264)
    assert int(nheavy) == 1 and int(order[0]) == 7
    # the Python rule and the CUDA sources agree on their sizes
    assert plan.PLAN_BUCKETS == emulate.define("raster_common.cuh",
                                               "PLAN_BUCKETS")
    assert plan.THREADS == emulate.define("raster_common.cuh", "THREADS")


# ---- subtile_exit: the per-group exit against splat_tpu's ----------------

# splat_tpu's tests/test_tiled.py holds its subtile_exit image to the
# whole-tile one at this tolerance
SUBTILE_ATOL = 1e-6
SH = SW = 128           # a 4 x 4 grid of 32-px tiles
_SUBTILE_CASES = {
    "default_heavy_pairs": dict(subtile_exit=True),
    "heavy_pairs_0": dict(subtile_exit=True, subtile_heavy_pairs=0),
    # 24 px do not divide into 16-px groups: the whole-tile exit
    "tile_24x16": dict(subtile_exit=True, subtile_heavy_pairs=0, tile_px=24,
                       tile_py=16),
}


@pytest.fixture(scope="module")
def subtile_frames():
    """One surface frame (opaque surface over open background, where the
    groups of a tile saturate apart), binned by splat_tpu for each tile
    size, with splat_tpu's images (Pallas kernel, interpret mode): each
    case's subtile_exit image and the whole-tile one.  With every tile
    heavy, splat_tpu's phase compaction runs on it: one tile there drops
    to its last live group at its 8th window and walks on with that one."""
    from splat_tpu.utils.fixtures import surface_scene
    scene = surface_scene(2000, seed=2)
    cam = st.Camera.create(h=SH, w=SW, position=(0.0, -0.5, 2.5), yaw=0.2)
    proj = jax_project(scene, cam, st.RenderConfig(chunk=64))
    out, bins = {}, {}
    for name, kw in _SUBTILE_CASES.items():
        jcfg = st.RenderConfig(chunk=64, **kw)
        tile = (jcfg.tile_w, jcfg.tile_h)
        if tile not in bins:       # the pairs do not depend on the exit
            bins[tile] = jax_bins(proj, SH, SW, jcfg)
        out[name] = (_port_bins(bins[tile]), np.asarray(
            jax_raster(bins[tile], SH, SW, jcfg, interpret=True)))
    jb = bins[(32, 32)]
    out["whole"] = np.asarray(jax_raster(jb, SH, SW, st.RenderConfig(
        chunk=64), interpret=True))
    return out


@pytest.mark.parametrize("case", list(_SUBTILE_CASES))
def test_subtile_exit_matches_splat_tpu(subtile_frames, case):
    """The plain version's per-group exit against splat_tpu's on the same
    pairs.  Both stop a group only once its pixels are saturated, but at
    different points: splat_tpu checks its groups every 8 windows and,
    once at most 4 are live, walks those on until all of them have
    T < alpha_min, so its image may leave the whole-tile one by up to
    alpha_min (1.1e-3 on this frame); the port stops a group once its
    pixels have T < alpha_min / 4096, so its image stays within
    SUBTILE_ATOL of splat_tpu's whole-tile image.  Where splat_tpu's own
    grouped walk kept to its whole-tile image, the two subtile images
    agree at SUBTILE_ATOL; elsewhere within alpha_min."""
    bins, want = subtile_frames[case]
    ref_whole = subtile_frames["whole"]
    cfg = RenderConfig(chunk=64, **_SUBTILE_CASES[case])
    grid = group_grid(cfg.tile_w, cfg.tile_h, True)
    got, walked, gw = rasterize_tiles_plain(bins, SH, SW, cfg,
                                            return_walked=True,
                                            return_group_walked=True)
    whole = rasterize_tiles_plain(bins, SH, SW, dataclasses.replace(
        cfg, subtile_exit=False)).numpy()
    got = got.numpy()
    assert got.shape == want.shape == (SH, SW, 3)
    ng = 1 if grid is None else grid[0] * grid[1]
    assert gw.shape == (walked.numel(), ng)
    assert bool((gw <= walked[:, None]).all())
    diff = np.abs(got - want)
    if case == "heavy_pairs_0":
        # splat_tpu's compaction stopped groups early (its image left the
        # whole-tile one), and so did the port's groups
        ref_own = np.abs(want - ref_whole).max(axis=-1)
        assert ref_own.max() > 100 * SUBTILE_ATOL
        assert int((gw < walked[:, None]).sum()) > 0
        assert not np.array_equal(got, whole)
        np.testing.assert_allclose(got, ref_whole, atol=SUBTILE_ATOL, rtol=0)
        np.testing.assert_allclose(got, whole, atol=SUBTILE_ATOL, rtol=0)
        assert diff[ref_own <= SUBTILE_ATOL].max() <= SUBTILE_ATOL
        assert diff.max() < cfg.alpha_min
    else:
        # no tile is heavy (default: none holds 8192 pairs) or none
        # divides into groups: the whole-tile image, bit for bit, and
        # splat_tpu's at SUBTILE_ATOL
        pairs = (bins.tile_end - bins.tile_start).long()
        assert case == "tile_24x16" or int(pairs.max()) <= 8192
        assert not bool((gw < walked[:, None]).any())
        np.testing.assert_array_equal(got, whole)
        assert diff.max() <= SUBTILE_ATOL


@pytest.mark.parametrize("ppt,blocks", [(4, 1), (1, 4)],
                         ids=["one_block", "split_4"])
def test_grouped_walk_model_equals_plain(ppt, blocks):
    """The kernel's grouped walk (the group-by-group layout, a warp's
    groups, the tile's blocks voting on its end) as render/emulate.py
    models it,
    on a frame whose groups saturate at different batches: the same
    image and the same pairs walked by each group as the plain version."""
    bins, h, w, cfg = emulate.saturating_frame(64, True)
    cfg = dataclasses.replace(cfg, subtile_exit=True, subtile_heavy_pairs=0)
    want, walked, gw = rasterize_tiles_plain(bins, h, w, cfg,
                                             return_walked=True,
                                             return_group_walked=True)
    got, gw_m = emulate.grouped_composite(bins, h, w, cfg, ppt, blocks)
    assert torch.equal(gw_m, gw)
    # groups stop at different batches, the last with its tile
    for t in range(gw.shape[0]):
        assert len(set(gw[t].tolist())) > 1
        assert int(gw[t].max()) == int(walked[t])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("tw,th", [(32, 32), (32, 16), (16, 16), (48, 40),
                                   (64, 128)])
def test_group_strip_holds_its_pixels(tw, th):
    """A warp's strip in the grouped layout holds every pixel of its slots
    (the strip test may pass more pairs than its pixels keep, never
    fewer), and the layout takes each pixel of the tile once."""
    lx, ly = emulate.group_layout(tw, th)
    npix = tw * th
    assert sorted((ly * tw + lx).tolist()) == list(range(npix))
    for ppt in (1, 2, 4, 8, 16):
        for pa in range(0, npix, 32 * ppt):
            pb = min(pa + 32 * ppt, npix) - 1
            xa, xb, ya, yb = emulate.group_strip(pa, pb, tw)
            x, y = lx[pa:pb + 1], ly[pa:pb + 1]
            assert bool(((x >= xa) & (x <= xb) & (y >= ya)
                         & (y <= yb)).all()), (ppt, pa)
            if ppt <= 4:      # within one group: the rows it holds
                assert (xb - xa + 1) * (yb - ya + 1) == pb - pa + 1
    assert (GROUP_W, GROUP_H, GROUP_STOP_SHIFT) == tuple(
        emulate.define("raster.cu", name)
        for name in ("GROUP_W", "GROUP_H", "GROUP_STOP_SHIFT"))
