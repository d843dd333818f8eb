"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import splat_tpu_torch as stt
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.render import binning, emulate, kernels, plan
from splat_tpu_torch.render.expand import (expand_pair_keys,
                                           expand_pair_keys_plain)
from splat_tpu_torch.render.diff import (SPLIT_MIN_PAIRS, _walk_end,
                                         _windows,
                                         rasterize_train_bwd,
                                         rasterize_train_bwd_plain,
                                         rasterize_train_fwd,
                                         rasterize_train_fwd_plain)
from splat_tpu_torch.render.kernels import (rasterize_tiles,
                                            rasterize_tiles_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _frame(dev, cfg, h=200, w=300, n=20000):
    scene = stt.random_scene(n, seed=1, extent=2.0, scale_range=(0.005, 0.05),
                             device=dev)
    cam = stt.Camera.create(h=h, w=w, position=(0.0, 0.0, 4.0), yaw=0.4,
                            device=dev)
    return project_gaussians(scene, cam, cfg)


@pytest.mark.parametrize("dup", [4.0, 0.5], ids=["room", "overflow"])
def test_expand_kernel_equals_plain(dev, dup):
    cfg = stt.RenderConfig(max_dup_factor=dup)
    lay = binning.slot_layout(_frame(dev, cfg), 200, 300, cfg)
    before = expand_pair_keys.launches
    keys, owners = lay.expand()
    assert expand_pair_keys.launches == before + 1
    keys_p, owners_p = lay.expand(expand_pair_keys_plain)
    assert torch.equal(keys, keys_p) and torch.equal(owners, owners_p)


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(tile_px=16, chunk=64, alpha_channel=True, background=(0.3, 0.2, 0.1)),
    dict(tile_px=32, tile_py=16, sigma_cutoff=math.inf),
    dict(tile_px=64, chunk=256),
    dict(tile_px=48, tile_py=40, chunk=32),
    dict(chunk=1100),        # a batch staged in two parts
    dict(tile_px=64, tile_py=128),   # 8192 px: a cluster of 2 blocks a tile
    dict(tile_px=128, chunk=64, alpha_channel=True),  # 4 blocks a tile
    dict(chunk=2500),        # a batch staged in three parts
], ids=["default", "t16_rgba", "t32x16_inf", "t64", "t48x40", "chunk1100",
        "t64x128", "t128_rgba", "chunk2500"])
def test_raster_kernel_equals_plain(dev, cfg_kw):
    cfg = stt.RenderConfig(**cfg_kw)
    h, w = 200, 300
    bins = binning.build_tile_bins(_frame(dev, cfg, h, w), h, w, cfg)
    before = rasterize_tiles.launches
    img = rasterize_tiles(bins, h, w, cfg)
    assert rasterize_tiles.launches == before + 1
    img_p = rasterize_tiles_plain(bins, h, w, cfg)
    torch.cuda.synchronize()
    assert img.shape == img_p.shape
    # same f32 operations in the same order: only expf rounding may differ
    assert float((img - img_p).abs().max()) <= 1e-4


def test_expand_kernel_long_runs_without_tiles(dev):
    """Runs of gaussians that cover no tile, longer than the kernel's
    shared-memory buffer, between gaussians that do: those blocks search
    global memory, and give the same integers."""
    g = torch.Generator().manual_seed(3)
    n = 60_000
    hgt = torch.randint(1, 4, (n,), generator=g, dtype=torch.int32)
    sw = torch.randint(1, 5, (n,), generator=g, dtype=torch.int32)
    seen = torch.rand(n, generator=g) < 0.5
    seen[1000:9000] = False          # no tile for 8000 gaussians in a row
    seen[20_000:20_003] = True
    seen[20_003:45_000] = False      # and for 24,997
    seen[-1] = False                 # the last gaussian covers none
    counts = torch.where(seen, sw * hgt, torch.zeros_like(sw)).long()
    cum = torch.cumsum(counts, 0)
    total = int(cum[-1])
    args = [t.to(dev) for t in (
        cum - counts, torch.randint(0, 6, (n,), generator=g,
                                    dtype=torch.int32),
        torch.randint(0, 5, (n,), generator=g, dtype=torch.int32), sw,
        torch.rand(n, generator=g).view(torch.int32), cum[-1:].clone())]
    for k_cap in (total + 777, total, total - 1, total // 3 + 1, 1):
        kw = dict(k_cap=k_cap, ntx=10, num_tiles=80)
        keys, owners = expand_pair_keys(*args, **kw)
        keys_p, owners_p = expand_pair_keys_plain(*args, **kw)
        assert torch.equal(keys, keys_p), k_cap
        assert torch.equal(owners, owners_p), k_cap
    # the kernel's Python model at the kernel's sizes, on the same spans:
    # the same integers, and blocks of both kinds (searching the staged
    # copy, searching global memory) among them
    first, tx0, ty0, span_w, dbits, _ = (a.cpu().numpy() for a in args)
    keys_m, owners_m, staged, direct = emulate.expand_by_blocks(
        first, tx0, ty0, span_w, dbits, total, total + 777, 10, 80)
    keys, owners = expand_pair_keys(*args, k_cap=total + 777, ntx=10,
                                    num_tiles=80)
    assert np.array_equal(keys.cpu().numpy(), keys_m)
    assert np.array_equal(owners.cpu().numpy(), owners_m)
    assert staged > 0 and direct > 0


# name: (config, scene of _train_frame); every case has tiles that hold
# more than SPLIT_MIN_PAIRS pairs, which K2 splits across a cluster
_SPLIT_RASTER_CASES = {
    "stacked": (dict(), "stacked"),
    "early_exit": (dict(), "deep"),
    "early_exit_chunk64_rgba": (dict(chunk=64, alpha_channel=True,
                                     background=(0.3, 0.2, 0.1)), "deep"),
    "stacked_sigma_inf": (dict(sigma_cutoff=math.inf), "stacked"),
}


@pytest.mark.parametrize("case", list(_SPLIT_RASTER_CASES))
def test_raster_kernel_split_tiles_equal_plain(dev, case):
    h, w = 200, 300
    cfg_kw, kind = _SPLIT_RASTER_CASES[case]
    cfg, bins = _train_frame(dev, (cfg_kw, kind), h, w)
    img = rasterize_tiles(bins, h, w, cfg)
    assert int(rasterize_tiles.split_tiles) > 0
    img_p, walked = rasterize_tiles_plain(bins, h, w, cfg,
                                          return_walked=True)
    torch.cuda.synchronize()
    assert img.shape == img_p.shape == (h, w, 4 if cfg.alpha_channel else 3)
    # same f32 operations in the same order: only expf rounding may differ
    assert float((img - img_p).abs().max()) <= 1e-4
    pairs = (bins.tile_end - bins.tile_start).long()
    if kind == "deep":   # a split tile's cluster stopped before its end
        assert bool(((pairs > SPLIT_MIN_PAIRS) & (walked < pairs)).any())
    # the work list the kernel built for itself, against its plain version:
    # every tile once, the same tiles split, in bucket order
    order = rasterize_tiles.tile_order.long()
    _, nheavy_p = plan._tile_plan(pairs, plan._split(4), plan._slots(dev))
    key = plan._plan_keys(pairs, plan._split(4), plan._slots(dev))
    assert torch.equal(torch.sort(order)[0],
                       torch.arange(pairs.numel(), device=dev))
    assert int(rasterize_tiles.split_tiles) == int(nheavy_p)
    assert bool((key[order][1:] >= key[order][:-1]).all())


@pytest.mark.parametrize("chunk", [64, 128])
def test_raster_kernel_staggered_exit_equals_plain(dev, chunk):
    """Two split tiles whose four pixel groups saturate at different
    batches (the top rows within a few batches, the bottom row, which the
    fading splats never reach, only at the flat ones), so a saturated block
    waits on the others' votes for dozens of batches; tile 0's last pixel
    falls below alpha_min with the last pair of a batch, so that one batch
    more or fewer shows in the image."""
    kw = dict(counts=(4500, 4300), fade=3064, fade_opacity=0.05, c2=-0.002,
              h=32)
    rgba = chunk == 64
    bins, h, w, cfg = emulate.saturating_frame(chunk, rgba, device=dev, **kw)
    img = rasterize_tiles(bins, h, w, cfg)
    assert int(rasterize_tiles.split_tiles) == 2
    img_p, walked = rasterize_tiles_plain(bins, h, w, cfg,
                                          return_walked=True)
    torch.cuda.synchronize()
    pairs = (bins.tile_end - bins.tile_start).long()
    assert bool((walked < pairs).all()) and int(walked[0]) == 3072
    assert float((img - img_p).abs().max()) <= 1e-4
    # the model of the split tile: the groups' votes differ for many
    # batches, and the tile stops where the plain version does
    cpu_bins = emulate.saturating_frame(chunk, rgba, **kw)[0]
    img_m, walked_m, stopped = emulate.split_composite(cpu_bins, h, w, cfg)
    assert torch.equal(walked_m, walked.cpu())
    for s in stopped:
        assert min(s) >= 0 and len(set(s)) >= 3 and max(s) - min(s) >= 20
    assert float((img.cpu() - img_m).abs().max()) <= 1e-4
    # the gate tells the exit batch: tile 0 walked one batch fewer or more
    # (one batch of 1100 ends at neither) differs by far more than 1e-4
    for d in (-chunk, chunk):
        end = bins.tile_end.clone()
        end[0] = bins.tile_start[0] + int(walked[0]) + d
        other = rasterize_tiles_plain(
            dataclasses.replace(bins, tile_end=end), h, w,
            dataclasses.replace(cfg, chunk=1100))
        assert float((other - img_p)[:, :32].abs().max()) > 1e-3, d


# ---- subtile_exit: K2's per-group exit; cull_pairs: K1's cull ----------

# config (subtile_exit on, every tile heavy) -> what the case covers; on
# the "deep" frame of _train_frame, whose tiles saturate group by group
_SUBTILE_RASTER_CASES = {
    "t32_split": dict(),                          # 4 px a thread; split tiles
    "t16_rgba": dict(tile_px=16, chunk=64, alpha_channel=True,
                     background=(0.3, 0.2, 0.1)),  # 1 px a thread
    "t32x16_sigma_inf": dict(tile_py=16, sigma_cutoff=math.inf),  # 2
    "t64": dict(tile_px=64, chunk=256),           # 16: 4 groups a warp
    "t64x128": dict(tile_px=64, tile_py=128),     # 8192 px: 2 blocks a tile
    "t24x16_whole": dict(tile_px=24, tile_py=16),  # no 16-px groups
}


@pytest.mark.parametrize("case", list(_SUBTILE_RASTER_CASES))
def test_raster_subtile_kernel_equals_plain(dev, case):
    h, w = 200, 300
    kw = dict(subtile_exit=True, subtile_heavy_pairs=0,
              **_SUBTILE_RASTER_CASES[case])
    cfg, bins = _train_frame(dev, (kw, "deep"), h, w)
    grouped = kernels.group_grid(cfg.tile_w, cfg.tile_h, True) is not None
    before = (rasterize_tiles.launches, rasterize_tiles.subtile_launches)
    img = rasterize_tiles(bins, h, w, cfg)
    assert (rasterize_tiles.launches, rasterize_tiles.subtile_launches) == (
        before[0] + 1, before[1] + int(grouped))
    split = int(rasterize_tiles.split_tiles)
    img_p, walked, gw = rasterize_tiles_plain(bins, h, w, cfg,
                                              return_walked=True,
                                              return_group_walked=True)
    torch.cuda.synchronize()
    assert img.shape == img_p.shape
    assert float((img - img_p).abs().max()) <= 1e-4
    whole = rasterize_tiles(bins, h, w, dataclasses.replace(
        cfg, subtile_exit=False))
    if not grouped:   # the kernel as it was, bit for bit
        assert torch.equal(img, whole)
        return
    # groups of a tile stopped at different batches, so the image is not
    # the whole-tile one: the exit above is the per-group one.  A group
    # stops only below T < alpha_min / 4096, so the image stays within
    # splat_tpu's subtile tolerance (tests/test_tiled.py) of the whole-tile
    # one
    stopped = gw < walked[:, None]
    assert bool(stopped.any())
    assert not torch.equal(img, whole)
    assert float((img - whole).abs().max()) <= 1e-6
    if case == "t32_split":       # ... on tiles split across blocks
        pairs = (bins.tile_end - bins.tile_start).long()
        assert split > 0
        assert bool((stopped.any(dim=1) & (pairs > SPLIT_MIN_PAIRS)).any())


def test_raster_subtile_staggered_groups_equal_model(dev):
    """The staggered frame of the split-tile test, every tile on the
    grouped walk: tile 0's top groups saturate within a few batches and
    its bottom ones only at the flat splats; each group stops on its own,
    in the kernel, its plain version and its model alike."""
    kw = dict(counts=(4500, 4300), fade=3064, fade_opacity=0.05, c2=-0.002,
              h=32)
    bins, h, w, cfg = emulate.saturating_frame(64, True, device=dev, **kw)
    cfg = dataclasses.replace(cfg, subtile_exit=True, subtile_heavy_pairs=0)
    img = rasterize_tiles(bins, h, w, cfg)
    assert int(rasterize_tiles.split_tiles) == 2
    img_p, walked, gw = rasterize_tiles_plain(bins, h, w, cfg,
                                              return_walked=True,
                                              return_group_walked=True)
    torch.cuda.synchronize()
    assert float((img - img_p).abs().max()) <= 1e-4
    # groups that stop thousands of pairs before others of their tile
    assert bool(((gw.max(dim=1).values - gw.min(dim=1).values)
                 > 1000).all())
    cpu_bins = emulate.saturating_frame(64, True, **kw)[0]
    img_m, gw_m = emulate.grouped_composite(cpu_bins, h, w, cfg, 1, 4)
    assert torch.equal(gw_m, gw.cpu())
    assert float((img.cpu() - img_m).abs().max()) <= 1e-4


def _segment_specs(seg):
    """render/emulate.py's segment_frame tiles, with the exit placed at
    offsets of the card's segment length ``seg``: in the first batch, never,
    inside a middle segment, on a segment border, and with later segments
    that stop on their own."""
    return [dict(n=10200, flats=[7]), dict(n=10000),
            dict(n=11000, flats=[2 * seg + seg // 2 + 13]),
            dict(n=10500, flats=[2 * seg - 1]),
            dict(n=12000, flats=[seg + 300] + [
                j * seg + 37 * j + 20 for j in range(2, 6)])]


@pytest.mark.parametrize("chunk,rgba", [(64, True), (128, False)])
def test_raster_kernel_segments_equal_plain_and_model(dev, chunk, rgba):
    """Tiles longer than two depth segments: K2 cuts each into segments,
    walks them in parallel and merges them, against the plain serial walk
    and the model of the segmented walk; the segments counter reads what
    the model planned and walked again."""
    seg = plan._segment_len(plan.SPLIT_MIN_PAIRS, chunk)
    specs = _segment_specs(seg)
    kw = dict(chunk=chunk, tile=32, h=30)
    bins, h, w, cfg = emulate.segment_frame(specs, device=dev, **kw)
    cfg = dataclasses.replace(cfg, alpha_channel=rgba)
    seg_p, nseg = plan._segments(bins.tile_start, bins.tile_end,
                                 plan._split(4), plan._slots(dev), chunk)
    assert seg_p == seg and bool((nseg > 2).all())
    img = rasterize_tiles(bins, h, w, cfg)
    planned, again = rasterize_tiles.segments.tolist()
    img_p, walked = rasterize_tiles_plain(bins, h, w, cfg,
                                          return_walked=True)
    torch.cuda.synchronize()
    assert img.shape == img_p.shape == (h, w, 4 if rgba else 3)
    assert float((img - img_p).abs().max()) <= 1e-4
    cpu_bins = emulate.segment_frame(specs, **kw)[0]
    img_m, walked_m, info = emulate.segment_composite(
        cpu_bins, h, w, cfg, seg, nseg.cpu())
    assert torch.equal(walked_m, walked.cpu())
    assert float((img.cpu() - img_m).abs().max()) <= 1e-4
    assert planned == int(nseg.sum()) and again == int(info["again"].sum())
    assert info["k"].tolist()[:2] == [0, int(nseg[1])] and again == 3
    # every tile is heavy, as K3 plans it too: its work list as before
    rasterize_train_fwd(bins, h, w, cfg)
    walk = (bins.tile_end - bins.tile_start).long()
    assert int(rasterize_train_fwd.split_tiles) == int(plan._tile_plan(
        walk, plan._split(4), plan._slots(dev))[1]) == len(specs)


def test_raster_kernel_plans_no_segment_without_heavy_tiles(dev):
    cfg = stt.RenderConfig()
    h, w = 200, 300
    bins = binning.build_tile_bins(_frame(dev, cfg, h, w, n=5000), h, w, cfg)
    _, nseg = plan._segments(bins.tile_start, bins.tile_end, plan._split(4),
                             plan._slots(dev), cfg.chunk)
    assert int(nseg.sum()) == 0
    rasterize_tiles(bins, h, w, cfg)
    assert rasterize_tiles.segments.tolist() == [0, 0]


def test_raster_kernel_segments_replay_eager_bit_for_bit(dev):
    """K2 with depth segments captured into a CUDA graph: each replay (the
    plan zeroes the tiles' counters of finished segments anew) equals the
    eager launch bit for bit, and the counter reads the graph's."""
    seg = plan._segment_len(plan.SPLIT_MIN_PAIRS, 64)
    bins, h, w, cfg = emulate.segment_frame(_segment_specs(seg), tile=32,
                                            h=30, device=dev)
    want = rasterize_tiles(bins, h, w, cfg)
    counts = rasterize_tiles.segments.tolist()
    assert counts[0] > 0 and counts[1] > 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rasterize_tiles(bins, h, w, cfg)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = rasterize_tiles(bins, h, w, cfg)
    captured = rasterize_tiles.segments
    for _ in range(3):
        got.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert captured.tolist() == counts


@pytest.mark.parametrize("dup", [16.0, 1.0], ids=["room", "overflow"])
def test_expand_cull_kernel_equals_plain(dev, dup):
    """K1's cull variant against its plain version on big splats (many
    pairs past their kill radius): the same keys and owners, so the same
    pairs culled and kept; the cull's never-cull rows among them."""
    cfg = stt.RenderConfig(max_dup_factor=dup, cull_pairs=True)
    scene = stt.random_scene(3000, seed=5, extent=1.5,
                             scale_range=(0.05, 0.4), device=dev)
    cam = stt.Camera.create(h=200, w=300, position=(0.0, 0.0, 4.0),
                            device=dev)
    proj = project_gaussians(scene, cam, cfg)
    lay = binning.slot_layout(proj, 200, 300, cfg)
    cull = lay.cull.clone()
    cull[::5, 3] = math.inf                 # never cull every fifth
    lay = dataclasses.replace(lay, cull=cull)
    before = (expand_pair_keys.launches, expand_pair_keys.cull_launches)
    keys, owners = lay.expand()
    assert (expand_pair_keys.launches, expand_pair_keys.cull_launches) == (
        before[0] + 1, before[1] + 1)
    keys_p, owners_p = lay.expand(expand_pair_keys_plain)
    assert torch.equal(keys, keys_p) and torch.equal(owners, owners_p)
    keys0, _ = dataclasses.replace(lay, cull=None).expand()
    sentinel = (lay.tiles_x * lay.tiles_y) << 32
    culled = (keys == sentinel) & (keys0 != sentinel)
    assert int(culled.sum()) > 20
    assert int((keys != sentinel).sum()) + int(culled.sum()) == min(
        int(lay.total[0]), lay.k_cap)


def test_strip_test_on_card_equals_model(dev):
    """``strip_reaches`` as compiled for the card against its Python model
    on the same strips and boxes: centres on pixel boundaries, saturated
    (+inf) radii and NaN centres included."""
    rng = np.random.default_rng(0)
    n = 200_000
    f32 = np.float32
    xa = rng.integers(0, 2000, n)
    ya = rng.integers(0, 1100, n)
    xb = xa + rng.choice([0, 7, 15, 31], n)
    yb = ya + rng.choice([0, 0, 3, 7, 31], n)
    cx = (xa + rng.uniform(-40, 72, n)).astype(f32)
    cy = (ya + rng.uniform(-40, 72, n)).astype(f32)
    snap = rng.integers(0, 4, n)
    cx = np.where(snap == 1, np.round(cx), np.where(
        snap == 2, np.floor(cx) + f32(0.5), cx)).astype(f32)
    cy = np.where(snap == 1, np.round(cy), np.where(
        snap == 2, np.floor(cy) + f32(0.5), cy)).astype(f32)
    r = (rng.integers(0, 400, (2, n)) * 0.125).astype(f32)
    rx2, ry2 = r[0] * r[0], r[1] * r[1]
    rx2[rng.random(n) < 0.1] = np.inf
    ry2[rng.random(n) < 0.1] = np.inf
    nan = rng.random(n) < 0.05
    cx[nan] = np.nan
    cy[nan & (rng.random(n) < 0.5)] = np.nan
    strips = np.stack([xa, xb, ya, yb]).astype(f32)
    boxes = np.stack([cx, cy, rx2, ry2])
    with np.errstate(invalid="ignore"):
        want = emulate.strip_reaches(*strips, *boxes)
    got = emulate.strip_reaches_on_card(torch.from_numpy(strips).to(dev),
                                        torch.from_numpy(boxes).to(dev))
    assert np.array_equal(got.cpu().numpy(), want)
    assert 0.05 < want.mean() < 0.95 and not want[nan].any()


def test_render_on_card_matches_dense_and_cpu(dev):
    scene = stt.surface_scene(8000, seed=2, device="cpu")
    cam = stt.Camera.create(h=120, w=160, position=(0.0, -1.0, 4.0),
                            pitch=0.2, device="cpu")
    img = stt.render(scene.to(dev), cam.to(dev))
    assert img.device.type == "cuda"
    ref = stt.render_dense(scene.to(dev), cam.to(dev), chunk=64)
    assert stt.psnr(img, ref) >= 45.0
    cpu = stt.render(scene, cam)
    assert stt.psnr(img, cpu) >= 60.0


@pytest.mark.parametrize("cfg_kw", [{}, dict(render_mode="depth"),
                                    dict(tile_px=32, tile_py=16)],
                         ids=["default", "depth", "tiles_32x16"])
def test_packed_render_on_card_equals_unpacked(dev, cfg_kw):
    """render_tiled of the packed 20k scene equals the unpacked one bit
    for bit on the card: the same kernels on the same values; K1 and K2
    launch once each."""
    scene = stt.random_scene(20000, seed=1, extent=2.0,
                             scale_range=(0.005, 0.05), device=dev)
    cam = stt.Camera.create(h=200, w=300, position=(0.0, 0.0, 4.0), yaw=0.4,
                            device=dev)
    cfg = stt.RenderConfig(**cfg_kw)
    packed = scene.pack_device()
    assert packed.device == dev and packed.buffer.is_contiguous()
    want = stt.render_tiled(scene, cam, cfg)
    k1, k2 = expand_pair_keys.launches, rasterize_tiles.launches
    got = stt.render_tiled(packed, cam, cfg)
    assert expand_pair_keys.launches == k1 + 1
    assert rasterize_tiles.launches == k2 + 1
    assert got.mean() > 0.01 and torch.equal(got, want)


def test_pack_memo_on_card(dev):
    """The memo on the card: one pack per scene, a fresh one after an
    edit in place, and none made inside inference_mode is an inference
    tensor; render() reuses the memoized pack."""
    scene = stt.random_scene(5000, seed=3, device=dev)
    p1 = scene.pack_device()
    assert scene.pack_device() is p1
    assert p1.mx.device.type == "cuda"
    assert torch.equal(p1.sh[3 * 5 + 2], scene.sh[:, 5, 2])
    with torch.no_grad():
        scene.quats.mul_(1.0)
    p2 = scene.pack_device()
    assert p2 is not p1
    fresh = stt.random_scene(5000, seed=4, device=dev)
    cam = stt.Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0),
                            device=dev)
    with torch.inference_mode():
        img = stt.render(fresh, cam, method="tiled")
    packed = fresh.pack_device()
    assert not packed.buffer.is_inference()
    assert torch.equal(stt.render(fresh, cam, method="tiled"), img)
    assert fresh.pack_device() is packed


def test_slab_split_render_on_card_matches_render_tiled(dev):
    """K1 and K2 on the row slabs of a 4-way split (the tiled sharded
    render's slabs, 120 / 4 = 30 rows: the last tile row of each slab is
    partial), stitched, against one render_tiled: the limits of
    test_sharding.py for a slab-split render."""
    from splat_tpu_torch.parallel.sharding import render_slab_tiled
    cfg = stt.RenderConfig()
    scene = stt.surface_scene(8000, seed=2, device=dev)
    cam = stt.Camera.create(h=120, w=160, position=(0.0, -1.0, 4.0),
                            pitch=0.2, device=dev)
    proj = project_gaussians(scene, cam, cfg)
    k1, k2 = expand_pair_keys.launches, rasterize_tiles.launches
    slabs = [render_slab_tiled(proj, g * 30, 30, 160, cfg) for g in range(4)]
    assert expand_pair_keys.launches == k1 + 4
    assert rasterize_tiles.launches == k2 + 4
    assert all(int(ov) == 0 for _, ov in slabs)
    got = torch.cat([img for img, _ in slabs])
    want = stt.render_tiled(scene, cam, cfg)
    assert stt.psnr(got, want) >= 55.0
    assert float(((got - want).abs() > 1e-6).float().mean()) < 0.002


# K4's per-gaussian sums: atomics add the tiles' pair sums in a run-
# dependent order, and the pixel sums run in another order than torch's.
K4_REL_TOL = 1e-4      # per field, of the field's max |g|
K4_MIN_COS = 0.99999

# name: (config, scene); "split" cases have tiles above SPLIT_MIN_PAIRS,
# which the kernels split across blocks (K3's as a cluster)
_TRAIN_CASES = {
    "default": (dict(), "light"),
    "deep_exact_cut": (dict(), "deep"),
    "sat_exit_t16": (dict(train_sat_exit=True, tile_px=16, chunk=64),
                     "deep"),
    "clamp1_sigma_inf": (dict(alpha_clamp=1.0, sigma_cutoff=math.inf,
                              chunk=256), "deep"),
    "stacked_split": (dict(), "stacked"),
    "deep_exact_cut_split": (dict(), "deep"),
    "sat_exit_split": (dict(train_sat_exit=True), "deep"),
    "clamp1_sigma_inf_split": (dict(alpha_clamp=1.0, sigma_cutoff=math.inf),
                               "stacked"),
    # tiles of several pixel groups (K3's a voting cluster: these tiles
    # do not saturate, so no cut engages), and windows staged in parts
    "groups_t64x128": (dict(tile_px=64, tile_py=128), "deep"),
    "groups_t128_sat_exit": (dict(train_sat_exit=True, tile_px=128), "deep"),
    # ... and saturating: the frame's wholly inside tiles (4 of 64x128, 2
    # of 128x128) end their walks by the cluster's vote
    "deep_exact_cut_groups_t64x128": (dict(tile_px=64, tile_py=128),
                                      "wall"),
    "deep_exact_cut_groups_t128": (dict(tile_px=128), "wall"),
    "sat_exit_groups_t128": (dict(train_sat_exit=True, tile_px=128),
                             "wall"),
    "deep_exact_cut_chunk2048": (dict(chunk=2048), "deep"),
}


def _train_frame(dev, case, h=200, w=300):
    cfg_kw, kind = _TRAIN_CASES[case] if isinstance(case, str) else case
    cfg = stt.RenderConfig(max_dup_factor=16.0, **cfg_kw)
    if kind == "light":
        proj = _frame(dev, cfg, h, w)
    else:
        if kind == "deep":   # heavily overlapped, nearly opaque: saturates
            scene = stt.random_scene(20000, seed=4, extent=1.5,
                                     scale_range=(0.05, 0.2), device=dev)
            scene = dataclasses.replace(
                scene, opacities=torch.full_like(scene.opacities, 0.995))
        elif kind == "wall":  # large opaque splats filling the frame,
            n = 40000         # deep enough for the exact cut everywhere
            scene = stt.random_scene(n, seed=4, scale_range=(0.2, 0.4),
                                     device=dev)
            rng = np.random.default_rng(4)
            means = np.stack([rng.uniform(-7.0, 7.0, n),
                              rng.uniform(-5.0, 5.0, n),
                              rng.uniform(-0.3, 0.3, n)], axis=1)
            scene = dataclasses.replace(
                scene, means=torch.tensor(means, dtype=torch.float32,
                                          device=dev),
                opacities=torch.full_like(scene.opacities, 0.995))
        else:                # small splats stacked over a few tiles
            scene = stt.random_scene(8000, seed=4, extent=0.4,
                                     scale_range=(0.005, 0.03), device=dev)
        cam = stt.Camera.create(h=h, w=w, position=(0.0, 0.0, 4.0),
                                device=dev)
        proj = project_gaussians(scene, cam, cfg)
    bins = binning.build_tile_bins(proj, h, w, cfg)
    assert int(bins.overflow) == 0
    return cfg, bins


@pytest.mark.parametrize("case", list(_TRAIN_CASES))
def test_train_kernels_equal_plain(dev, case):
    h, w = 200, 300
    cfg, bins = _train_frame(dev, case, h, w)
    f0, b0 = rasterize_train_fwd.launches, rasterize_train_bwd.launches
    c, lt, cut = rasterize_train_fwd(bins, h, w, cfg)
    c_p, lt_p, cut_p = rasterize_train_fwd_plain(bins, h, w, cfg)
    torch.cuda.synchronize()
    assert rasterize_train_fwd.launches == f0 + 1
    # same f32 operations in the same order: only expf/log1pf may differ
    assert float((c - c_p).abs().max()) <= 1e-4
    assert float((lt - lt_p).abs().max()) <= 1e-4
    assert torch.equal(cut, cut_p)
    pairs = (bins.tile_end - bins.tile_start).long()
    split = case.endswith("_split")
    if split:    # K3 split at least one tile
        assert int(rasterize_train_fwd.split_tiles) > 0
    _, _, base, nch = _windows(bins, cfg.chunk)
    engaged = cut.long() < nch
    if case.startswith(("deep_exact_cut", "sat_exit")):
        assert bool(engaged.any())                  # the cut engaged
    if "_groups_" in case:                          # ... by a cluster's vote
        assert kernels._ppt(cfg)[1] > 1
    if split and case.startswith(("deep_exact_cut", "sat_exit")):
        assert bool((engaged & (pairs > SPLIT_MIN_PAIRS)).any())
    gen = torch.Generator(device=dev).manual_seed(0)
    g_c = torch.randn((h, w, 3), generator=gen, device=dev)
    g_lt = torch.randn((h, w), generator=gen, device=dev)
    g = rasterize_train_bwd(bins, g_c, g_lt, lt, cut, h, w, cfg)
    g_p = rasterize_train_bwd_plain(bins, g_c, g_lt, lt, cut, h, w, cfg)
    torch.cuda.synchronize()
    assert rasterize_train_bwd.launches == b0 + 1
    if split:    # K4 split at least one tile
        assert int(rasterize_train_bwd.split_tiles) > 0
    # both work lists split the tiles their plain version splits: K3's goes
    # by the pairs held, K4's by what the cut left of each walk (a tile of
    # several pixel groups is never split further)
    ppt, groups = kernels._ppt(cfg)
    left = _walk_end(bins, cfg.chunk, cut) - bins.tile_start
    for fn, walk in ((rasterize_train_fwd, pairs),
                     (rasterize_train_bwd, left)):
        assert int(fn.split_tiles) == int(plan._tile_plan(
            walk, plan._split(ppt) if groups == 1 else 1,
            plan._slots(dev))[1])
    assert bool(torch.isfinite(g).all())
    for q in range(g.shape[1]):
        scale = float(g_p[:, q].abs().max()) + 1e-30
        assert float((g[:, q] - g_p[:, q]).abs().max()) <= K4_REL_TOL * scale
    a, b = g.double().flatten(), g_p.double().flatten()
    assert float(a @ b / (a.norm() * b.norm())) >= K4_MIN_COS


def test_default_device_is_the_card(dev):
    cam = stt.Camera.create(h=8, w=8)
    scene = stt.random_scene(10, seed=0)
    assert cam.device == scene.device == torch.device("cuda", 0)


def test_tiled_fit_on_card(dev):
    truth = stt.random_scene(3000, seed=5, extent=1.5,
                             scale_range=(0.02, 0.08), device=dev)
    cams = stt.orbit_trajectory(
        stt.Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0),
                          device=dev), 2, yaw_sweep=0.5)
    cfg = stt.RenderConfig(max_dup_factor=8.0)
    targets = torch.stack([stt.render_dense(truth, c, cfg) for c in cams])
    start = dataclasses.replace(truth, sh=truth.sh * 0.7)
    f0, b0 = rasterize_train_fwd.launches, rasterize_train_bwd.launches
    res = stt.fit(start, cams, targets, steps=2, lr=5e-3, config=cfg,
                  method="tiled", dssim_weight=0.2)
    assert res.losses.shape == (2,)
    assert bool(torch.isfinite(res.losses).all())
    assert rasterize_train_fwd.launches == f0 + 4     # 2 steps x 2 views
    assert rasterize_train_bwd.launches == b0 + 4
    assert res.scene.means.device.type == "cuda"


def test_cli_render_and_viewer_on_card(dev, tmp_path):
    """`render` through the command line and one viewer frame, on the card:
    both launch K1 and K2 and equal the port's own render (uint8)."""
    import threading
    import urllib.request

    from splat_tpu_torch import cli
    from splat_tpu_torch.utils.image import read_png
    from splat_tpu_torch.viewer.server import make_server

    ply = str(tmp_path / "s.ply")
    stt.save_ply(ply, stt.random_scene(20_000, seed=2, extent=1.5,
                                       scale_range=(0.005, 0.04), device=dev))
    k1, k2 = expand_pair_keys.launches, rasterize_tiles.launches
    out = str(tmp_path / "r.png")
    assert cli.main(["render", ply, "--size", "320x240", "--pos", "0,0,4",
                     "--dup-factor", "4", "--no-center", "--out", out,
                     "--device", "cuda"]) == 0
    assert expand_pair_keys.launches > k1 and rasterize_tiles.launches > k2
    scene = stt.load_ply(ply, center=False, device=dev)
    cam = stt.Camera.create(h=240, w=320, position=(0.0, 0.0, 4.0),
                            device=dev)
    cfg = stt.RenderConfig(max_dup_factor=4.0)
    want = stt.render(scene, cam, cfg, as_uint8=True).cpu().numpy()
    got = read_png(out)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    srv = make_server(scene, cam, cfg, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        k2 = rasterize_tiles.launches
        url = f"http://127.0.0.1:{srv.server_address[1]}/frame.raw?yaw=0.2"
        with urllib.request.urlopen(url, timeout=120) as r:
            body, overflow = r.read(), r.headers["X-Splat-Overflow"]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert overflow == "0" and rasterize_tiles.launches > k2
    frame = np.frombuffer(body, np.uint8).reshape(240, 320, 4)[..., :3]
    want = stt.render(scene, cam.with_pose(yaw=0.2), cfg,
                      as_uint8=True).cpu().numpy()
    assert np.abs(frame.astype(int) - want.astype(int)).max() <= 1


# ---- the compiled frame (render/graph.py): captured CUDA graphs ----------

def _graph_frame(dev, n=20000, h=200, w=300):
    scene = stt.random_scene(n, seed=1, extent=2.0,
                             scale_range=(0.005, 0.05), device=dev)
    cam = stt.Camera.create(h=h, w=w, position=(0.0, 0.0, 4.0), yaw=0.4,
                            device=dev)
    return scene.pack_device(), cam


@pytest.mark.parametrize("cfg_kw", [{}, dict(render_mode="depth"),
                                    dict(subtile_exit=True,
                                         subtile_heavy_pairs=0,
                                         cull_pairs=True)],
                         ids=["default", "depth", "both_knobs"])
def test_compiled_frame_replays_eager_bit_for_bit(dev, cfg_kw):
    """render_fn on the card captures once and replays: each pose of a
    two-pose sequence equal bit for bit to eager render_tiled, K1 and K2
    counted once a replay, split_tiles pointing at the replayed graph."""
    from splat_tpu_torch.render import graph
    scene, cam = _graph_frame(dev)
    cfg = stt.RenderConfig(**cfg_kw)
    f = stt.render_fn("tiled", cfg)
    caps = graph.counts["captures"]
    for yaw in (0.0, 0.3):
        c = cam.with_pose(yaw=yaw)
        want = stt.render_tiled(scene, c, cfg)
        k1, k2 = expand_pair_keys.launches, rasterize_tiles.launches
        got = f(scene, c)
        if yaw == 0.0:            # the capture's warm-up launches once
            k1, k2 = k1 + 1, k2 + 1
        assert expand_pair_keys.launches == k1 + 1
        assert rasterize_tiles.launches == k2 + 1
        assert got.mean() > 0.01 and torch.equal(got, want), yaw
        split = rasterize_tiles.split_tiles
        assert split is not None and split.device == dev
    assert graph.counts["captures"] == caps + 1
    # a fresh tensor each call, as JAX returns a fresh array
    a, b = f(scene, c), f(scene, c)
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)


def test_compiled_frame_reads_an_in_place_edit(dev):
    from splat_tpu_torch.render import graph
    scene, cam = _graph_frame(dev)
    cfg = stt.RenderConfig()
    f = stt.render_fn("tiled", cfg)
    before = f(scene, cam)
    caps = graph.counts["captures"]
    scene.buffer[0].add_(0.05)             # every mean moves in x
    got = f(scene, cam)
    assert graph.counts["captures"] == caps        # the same graph
    assert not torch.equal(got, before)
    assert torch.equal(got, stt.render_tiled(scene, cam, cfg))
    # another buffer with the same values is another key, equal image
    other = stt.DeviceScene.from_buffer(scene.buffer.clone())
    assert torch.equal(f(other, cam), got)
    assert graph.counts["captures"] == caps + 1


def test_render_overflow_retry_through_graphs(dev):
    """render()'s auto capacity through graphs: a stale, too-small cached
    capacity is a capture of its own, overflows in its replay and is
    re-measured; the image equals the first render's."""
    from splat_tpu_torch.render import api, graph
    from splat_tpu_torch.render.tiled import CapacityOverflow
    scene = stt.random_scene(5000, seed=3, extent=2.0,
                             scale_range=(0.01, 0.06), device=dev)
    cam = stt.Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0),
                            device=dev)
    api._AUTO_CONFIG_CACHE.clear()
    img = stt.render(scene, cam)
    (key, (ref_w, cfg)), = api._AUTO_CONFIG_CACHE.items()
    small = stt.RenderConfig(max_dup_factor=0.05)
    api._AUTO_CONFIG_CACHE[key] = (ref_w, small)
    caps = graph.counts["captures"]
    again = stt.render(scene, cam)
    # the small capacity's capture overflowed; the re-measured capacity is
    # the first render's, whose graph is still cached
    assert graph.counts["captures"] == caps + 1
    assert torch.equal(again, img)
    assert api._AUTO_CONFIG_CACHE[key][1] == cfg
    with pytest.raises(CapacityOverflow):
        stt.render(scene, cam, small, method="tiled")
    assert torch.equal(img, stt.render_tiled(scene.pack_device(), cam, cfg))


@pytest.mark.parametrize("kind", ["edited", "inference"])
def test_render_of_a_changing_scene_captures_once(dev, kind):
    """render() of a GaussianScene edited in place between frames, and of
    a scene of inference tensors (re-packed every call): the pack is
    refilled where it lies, so one capture serves every frame, each equal
    to eager render_tiled, and reserved memory stops growing."""
    from splat_tpu_torch.render import graph
    with torch.inference_mode(kind == "inference"):
        scene = stt.random_scene(20000, seed=5, extent=2.0,
                                 scale_range=(0.005, 0.05), device=dev)
    cam = stt.Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0),
                            device=dev)
    cfg = stt.RenderConfig(max_dup_factor=8.0)
    graph.clear()
    caps = graph.counts["captures"]
    reserved = []
    for i in range(4):
        with torch.inference_mode(kind == "inference"), torch.no_grad():
            scene.opacities.mul_(0.9)
        img = stt.render(scene, cam, cfg, method="tiled")
        want = stt.render_tiled(scene.pack_device(), cam, cfg)
        assert torch.equal(img, want), i
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
    assert graph.counts["captures"] == caps + 1
    assert reserved[-1] == reserved[1], reserved


def test_viewer_render_pose_replays_eager(dev):
    from splat_tpu_torch.render import graph
    from splat_tpu_torch.viewer.server import make_server
    scene, cam = _graph_frame(dev, h=120, w=160)
    cfg = stt.RenderConfig(max_dup_factor=4.0)
    srv = make_server(scene, cam, cfg, port=0)
    try:
        for mode, scale in (("color", 1.0), ("depth", 1.0), ("color", 0.5),
                            ("color", 1.0)):
            reps = graph.counts["replays"]
            img, overflow = srv.render_pose(0.2, 0.1, 1.1, mode, scale)
            assert graph.counts["replays"] == reps + 1 and overflow == 0
            pos = (cam.position.cpu().numpy() * np.float32(1.1))
            c = cam.with_pose(yaw=0.2, pitch=0.1, position=pos)
            if scale != 1.0:
                c = dataclasses.replace(c, h=60, w=80)
            want = stt.render_tiled(scene, c, dataclasses.replace(
                cfg, render_mode=mode))
            want = (torch.clamp(want, 0, 1) * 255 + 0.5).to(torch.uint8)
            np.testing.assert_array_equal(img, want.cpu().numpy())
    finally:
        srv.server_close()


def test_failed_capture_raises_and_caches_nothing(dev):
    """A frame that syncs with the host cannot be captured: the capture
    raises, nothing is cached, and the card renders on."""
    from splat_tpu_torch.render import graph
    scene, cam = _graph_frame(dev, n=5000, h=64, w=64)
    cfg = stt.RenderConfig()

    def syncs(s, c):
        img = stt.render_tiled(s, c, cfg)
        return img * float(img.sum())          # a host read mid-frame

    k1 = expand_pair_keys.launches
    n = len(graph._CACHE)
    with pytest.raises(RuntimeError):
        graph.compiled(syncs, "syncs")(scene, cam)     # the shared pool
    assert len(graph._CACHE) == n
    assert expand_pair_keys.launches == k1 + 1     # the warm-up only
    with pytest.raises(RuntimeError):
        graph.capture(syncs, scene, cam)               # a pool of its own
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    # the cache's next capture goes into a new shared pool
    got = stt.render_fn("tiled", cfg)(scene, cam)
    assert torch.equal(got, stt.render_tiled(scene, cam, cfg))


def test_chained_bench_compiled_equals_eager(dev):
    from splat_tpu_torch.utils.benchmark import chained_bench
    scene, cam = _graph_frame(dev)
    cfg = stt.RenderConfig()
    k2 = rasterize_tiles.launches
    g = chained_bench(scene, cam, cfg, 4)
    # one warm-up frame, then the sweep's and the audit's warm-ups and one
    # replay each: 1 + 4 x 4 frames
    assert rasterize_tiles.launches == k2 + 17
    e = chained_bench(scene, cam, cfg, 4, compiled=False)
    assert g["mean_pixel"] == e["mean_pixel"] and g["compile_s"] > 0.0
    for k in ("overflow", "num_pairs", "visible"):
        assert g[k] == e[k], k
    assert e["compile_s"] == 0.0 and g["overflow"] == 0


@pytest.mark.parametrize("n, kw", [
    (1500, dict(grad_threshold=2e-4)),
    (1500, dict(grad_threshold=5e-5, min_opacity=0.3, split_factor=2.0,
                pad_multiple=1, seed=5)),
    (300_000, dict(grad_threshold=3e-4, seed=7)),
], ids=["default", "prune_heavy", "300k"])
def test_densify_round_on_card_equals_twin(dev, n, kw):
    """densify_and_prune of CUDA leaves stays on the card and equals the
    NumPy twin: counts, copied rows bit for bit, split children within
    exp's rounding (tests/test_torch_densify.py)."""
    from test_torch_densify import _check, _state

    stats = _check(*_state(n=n, seed=n % 97), device=dev, **kw)
    assert stats["cloned"] > 0 and stats["split"] > 0
    assert stats["pruned"] > 0


def test_fit_densifies_on_card(dev):
    """fit(densify_every=) on the card: every round on the card, and the
    round densify_cb reports equals the twin's on its inputs."""
    from test_torch_densify import assert_round_equal, split_bound

    from splat_tpu_torch import train as tt

    truth = stt.random_scene(3000, seed=5, extent=1.5,
                             scale_range=(0.02, 0.08), device=dev)
    cams = stt.orbit_trajectory(
        stt.Camera.create(h=96, w=128, position=(0.0, 0.0, 4.0),
                          device=dev), 2, yaw_sweep=0.5)
    targets = torch.stack([stt.render_tiled(truth, c) for c in cams])
    start = dataclasses.replace(truth, sh=truth.sh * 0.7)
    kw = dict(grad_threshold=2e-5, min_opacity=0.05, pad_multiple=64)
    calls = []
    r0 = tt.densify_and_prune.rounds
    d0 = tt.densify_and_prune.device_rounds
    res = stt.fit(start, cams, targets, steps=6, lr=5e-3, method="tiled",
                  dssim_weight=0.2, densify_every=2, densify_kwargs=kw,
                  densify_cb=lambda *a: calls.append(a))
    assert tt.densify_and_prune.rounds - r0 == 2 == len(calls)
    assert tt.densify_and_prune.device_rounds - d0 == 2
    assert bool(torch.isfinite(res.losses).all())
    before, grad_mean, after, stats = calls[0]
    assert stats["cloned"] > 0 and stats["split"] > 0
    plain, pstats = tt.densify_and_prune_plain(before, grad_mean, **kw)
    assert_round_equal(after, stats, plain, pstats,
                       split_bound(before, grad_mean, pstats, **kw))

