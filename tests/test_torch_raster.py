"""The compositing kernel's (K2) plain version held against splat_tpu's
Pallas raster kernel in interpret mode on the SAME pair lists: the JAX
binning's packed feature table is decoded into the port's f32 rows (CPU)."""

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
from splat_tpu_torch.render.kernels import rasterize_tiles_plain
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
