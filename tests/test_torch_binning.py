"""The PyTorch port's tile binning and pair-expansion (K1) plain version,
held against splat_tpu's binning (Pallas expansion in interpret mode, as
tests/test_tiled.py runs it) and against a hand-written expansion (CPU)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu.ops.projection import project_gaussians as jax_project
from splat_tpu.render.binning import build_tile_bins as jax_bins
from splat_tpu.render.binning import count_pairs as jax_count_pairs
from splat_tpu_torch.device import resolve_device
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.render import binning, emulate
from splat_tpu_torch.render.expand import (expand_pair_keys,
                                           expand_pair_keys_plain)
from splat_tpu_torch.render.diff import (rasterize_train_bwd,
                                         rasterize_train_fwd)
from splat_tpu_torch.render.kernels import (rasterize_tiles,
                                            rasterize_tiles_plain)

torch.set_num_threads(1)

H, W = 96, 128


@pytest.fixture(scope="module")
def frame():
    js = st.random_scene(2000, seed=11, extent=2.0, scale_range=(0.01, 0.1))
    ts = stt.GaussianScene.from_numpy(js.to_numpy(), device="cpu")
    kw = dict(h=H, w=W, position=(0.0, 0.0, 4.0), yaw=0.3, pitch=-0.2)
    jc, tc = st.Camera.create(**kw), stt.Camera.create(**kw, device="cpu")
    jcfg, tcfg = st.RenderConfig(chunk=64), stt.RenderConfig(chunk=64)
    jp = jax_project(js, jc, jcfg)
    tp = project_gaussians(ts, tc, tcfg)
    return jp, tp, jcfg, tcfg


def test_tile_bins_match_jax(frame):
    jp, tp, jcfg, tcfg = frame
    jb = jax_bins(jp, H, W, jcfg)
    tb = binning.build_tile_bins(tp, H, W, tcfg)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    js_, je = np.asarray(jb.tile_start), np.asarray(jb.tile_end)
    ts_, te = tb.tile_start.numpy(), tb.tile_end.numpy()
    # same pair multiset in every tile -> identical ranges
    np.testing.assert_array_equal(ts_, js_)
    np.testing.assert_array_equal(te, je)
    jr, tr = np.asarray(jb.ranks), tb.ranks.numpy()
    depth = tp.depth.numpy()
    for t in range(len(ts_)):
        ids = tr[ts_[t]:te[t]]
        assert sorted(ids) == sorted(jr[js_[t]:je[t]]), t
        # exact front-to-back order, ties broken by gaussian index
        key = list(zip(depth[ids], ids))
        assert key == sorted(key), t
    _, pairs = jax_count_pairs(jp, H, W, jcfg)
    assert int(tb.num_pairs) == int(pairs) == int(jb.num_pairs) > 0
    assert int(tb.overflow) == 0 == int(jb.overflow)
    vis, tpairs = binning.count_pairs(tp, H, W, tcfg)
    assert int(tpairs) == int(pairs)
    assert int(vis) == int(np.asarray(jp.visible).sum())
    # feature rows carry each pair's own gaussian
    cx = tb.features[binning.FEATURE_ROWS.index("cx"), :int(tb.num_pairs)]
    np.testing.assert_array_equal(
        cx.numpy(), tp.center_px[:, 0].numpy()[tb.ranks[:len(cx)].numpy()])


def test_overflow_is_counted_never_silent(frame):
    _, tp, _, tcfg = frame
    _, pairs = binning.count_pairs(tp, H, W, tcfg)
    small = stt.RenderConfig(chunk=64, max_dup_factor=0.25)
    tb = binning.build_tile_bins(tp, H, W, small)
    k_cap = int(0.25 * tp.depth.shape[0])
    assert int(pairs) > k_cap
    assert int(tb.num_pairs) == k_cap
    assert int(tb.num_pairs) + int(tb.overflow) == int(pairs)
    assert int((tb.tile_end - tb.tile_start).sum()) == k_cap


def _expand_by_hand(first, tx0, ty0, sw, dbits, total, k_cap, ntx, nt):
    keys = [nt << 32] * k_cap
    owners = [0] * k_cap
    counts = np.diff(np.append(first, total))
    for g, c in enumerate(counts):
        for r in range(c):
            k = first[g] + r
            if k < k_cap:
                tile = (ty0[g] + r // sw[g]) * ntx + tx0[g] + r % sw[g]
                keys[k] = (int(tile) << 32) | (int(dbits[g]) & 0xFFFFFFFF)
                owners[k] = g
    return keys, owners


@pytest.mark.parametrize("k_cap", [40, 23, 0], ids=["room", "overflow",
                                                    "empty"])
def test_expand_plain_matches_hand_expansion(k_cap):
    # gaussians 1, 3, 4 and 7 cover no tile (zero counts, no fake slots)
    tx0 = np.array([0, 0, 2, 0, 0, 5, 1, 0, 3], np.int32)
    ty0 = np.array([0, 0, 1, 0, 0, 0, 2, 0, 3], np.int32)
    sw = np.array([2, 1, 3, 1, 1, 1, 2, 1, 4], np.int32)
    hgt = np.array([1, 0, 2, 0, 0, 3, 2, 0, 2], np.int32)
    counts = np.where(hgt > 0, sw * hgt, 0)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    total = int(counts.sum())
    dbits = np.float32(np.linspace(0.5, 4.0, 9)).view(np.int32)
    ntx, nt = 8, 40
    keys, owners = expand_pair_keys_plain(
        torch.from_numpy(first), torch.from_numpy(tx0),
        torch.from_numpy(ty0), torch.from_numpy(sw), torch.from_numpy(dbits),
        torch.tensor([total]), k_cap=k_cap, ntx=ntx, num_tiles=nt)
    want_k, want_o = _expand_by_hand(first, tx0, ty0, sw, dbits, total,
                                     k_cap, ntx, nt)
    assert keys.dtype == owners.dtype == torch.int64
    assert keys.tolist() == want_k
    assert owners.tolist() == want_o


def test_cpu_tensors_take_plain_versions(frame):
    _, tp, _, tcfg = frame
    kernels = (expand_pair_keys, rasterize_tiles, rasterize_train_fwd,
               rasterize_train_bwd)
    for fn in kernels:
        fn.launches = 0
    tb = binning.build_tile_bins(tp, H, W, tcfg)
    rasterize_tiles(tb, H, W, tcfg)
    c, lt, cut = rasterize_train_fwd(tb, H, W, tcfg)
    rasterize_train_bwd(tb, torch.ones_like(c), torch.ones_like(lt), lt, cut,
                        H, W, tcfg)
    assert [fn.launches for fn in kernels] == [0, 0, 0, 0]
    # any other device raises instead of falling back
    lay = binning.slot_layout(tp, H, W, tcfg)
    meta = [t.to("meta") for t in (lay.first_slot, lay.tx0, lay.ty0,
                                   lay.span_w, lay.depth_bits, lay.total)]
    with pytest.raises(ValueError):
        expand_pair_keys(*meta, k_cap=lay.k_cap, ntx=lay.tiles_x,
                         num_tiles=lay.tiles_x * lay.tiles_y)
    meta_bins = dataclasses.replace(tb, features=tb.features.to("meta"))
    for fn in (rasterize_tiles, rasterize_train_fwd):
        with pytest.raises(ValueError):
            fn(meta_bins, H, W, tcfg)


_DEFAULT_DEVICE_MAKERS = {
    "camera": lambda: stt.Camera.create(h=8, w=8),
    "scene": lambda: stt.GaussianScene.create(
        np.zeros((1, 3)), np.ones((1, 4)), np.ones((1, 3)), np.ones(1),
        np.zeros((1, 16, 3))),
    "random_scene": lambda: stt.random_scene(4),
    "naive_gaussians": lambda: stt.naive_gaussians(),
    "load_ply": lambda: stt.load_ply(os.path.join(
        os.path.dirname(__file__), "data", "surface_5k.ply")),
}


@pytest.mark.parametrize("make", list(_DEFAULT_DEVICE_MAKERS))
def test_default_device_is_the_card_never_the_cpu(monkeypatch, make):
    """No device= means cuda:0; without a card that raises instead of
    quietly building CPU tensors (which would take the plain versions)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _DEFAULT_DEVICE_MAKERS[make]()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_radius_bits_saturate_and_survive_nan():
    rx = torch.tensor([0.01, 2.5, 5000.0, float("inf"), float("nan")])
    ry = torch.tensor([1.0, 0.0, 1.0, 1.0, float("nan")])
    vis = torch.tensor([True, True, True, True, False])
    bits = binning.quantize_radius_bits(rx, ry, vis)
    drx, _, dvis = binning.decode_radius_bits(bits)
    assert drx.tolist()[:3] == [0.125, 2.5, float("inf")]
    assert drx[3] == float("inf") and drx[4] == 0.0
    assert dvis.tolist() == vis.tolist()
    tx0, ty0, sw, counts = binning.tile_spans(
        torch.tensor([10.0, 40.0, 50.0, 60.0, float("nan")]),
        torch.tensor([10.0] * 4 + [float("nan")]), bits, 32, 32, 4, 3)
    assert sw.tolist()[2:4] == [4, 4] and counts[4] == 0


# ---- K1's design: its Python model (render/emulate.py), which the tests
# ---- on the card hold the kernel against ---------------------------------


def _spans(n, gaps, seed=4):
    """Random tile spans of n gaussians; those in ``gaps`` cover no tile."""
    rng = np.random.default_rng(seed)
    sw = rng.integers(1, 4, n).astype(np.int32)
    hgt = rng.integers(1, 3, n).astype(np.int32)
    seen = rng.random(n) < 0.6
    for a, b in gaps:
        seen[a:b] = False
    seen[-5:] = False
    counts = np.where(seen, sw * hgt, 0).astype(np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    tx0 = rng.integers(0, 5, n).astype(np.int32)
    ty0 = rng.integers(0, 3, n).astype(np.int32)
    dbits = rng.uniform(0.5, 9.0, n).astype(np.float32).view(np.int32)
    return first, tx0, ty0, sw, dbits, int(counts.sum())


# runs of gaussians with no tile, longer than the staging buffer: 64 entries
# in the small case; the kernel's own sizes (read from csrc/expand.cu) in
# the other
_BLOCK_CASES = {
    "small": (700, [(40, 130), (300, 420)],
              dict(slots_per_block=32, stage_cap=64, ways=4)),
    "kernel_sizes": (16000, [(500, 3000), (7000, 12000)], {}),
}


@pytest.mark.parametrize("sizes", list(_BLOCK_CASES))
@pytest.mark.parametrize("cap", ["room", "exact", "overflow"])
def test_expand_block_ranges_match_plain(cap, sizes):
    n, gaps, kw = _BLOCK_CASES[sizes]
    first, tx0, ty0, sw, dbits, total = _spans(n, gaps)
    ntx, nt = 8, 40
    k_cap = {"room": total + 37, "exact": total, "overflow": total // 2}[cap]
    want_k, want_o = expand_pair_keys_plain(
        *(torch.from_numpy(a) for a in (first, tx0, ty0, sw, dbits)),
        torch.tensor([total]), k_cap=k_cap, ntx=ntx, num_tiles=nt)
    keys, owners, staged, direct = emulate.expand_by_blocks(
        first, tx0, ty0, sw, dbits, total, k_cap, ntx, nt, **kw)
    assert keys.tolist() == want_k.tolist()
    assert owners.tolist() == want_o.tolist()
    assert staged > 0 and direct > 0          # both paths ran
    # the search the kernel's halves run: 128 probes a round
    ways = emulate.define("expand.cu", "THREADS") // 2
    for k in (0, 1, total // 3, total - 1):
        g, rounds = emulate.multiway_upper_bound(first, k, ways)
        assert g == int(np.searchsorted(first, k, side="right"))
        assert rounds <= 2                    # n <= 128^2


# ---- cull_pairs: K1's dead-pair cull -------------------------------------


def _culled(lay):
    """The slots the cull dropped: (owner, tile) of each, from the plain
    expansion with and without the cull."""
    keys, _ = lay.expand(expand_pair_keys_plain)
    keys0, owners0 = dataclasses.replace(lay, cull=None).expand(
        expand_pair_keys_plain)
    sentinel = (lay.tiles_x * lay.tiles_y) << 32
    dead = (keys == sentinel) & (keys0 != sentinel)
    return owners0[dead], keys0[dead] >> 32


def _alpha_at_tile(proj, owners, tiles, lay, cfg):
    """The raster kernel's f32 alpha of each (owner, tile) at every pixel
    of the tile (rows: pairs)."""
    tw, th = lay.tile_wh
    lin = torch.arange(tw * th)
    px = ((tiles % lay.tiles_x)[:, None] * tw + lin % tw).float()
    py = ((tiles // lay.tiles_x)[:, None] * th + lin // tw).float()
    cx, cy = (proj.center_px[owners, q][:, None] for q in (0, 1))
    a2, b2, c2 = (-0.5 * proj.conic[owners, 0][:, None],
                  -proj.conic[owners, 1][:, None],
                  -0.5 * proj.conic[owners, 2][:, None])
    dx, dy = px - cx, cy - py
    power = a2 * (dx * dx) + c2 * (dy * dy) + b2 * (dx * dy)
    op = proj.opacity[owners][:, None]
    return torch.clamp(op * torch.exp(power), max=cfg.alpha_clamp)


def test_cull_drops_only_pairs_no_pixel_keeps():
    """Random screen-space splats, thin ones among them, many near the cut:
    at every pixel of every culled pair's tile the raster kernel's own f32
    alpha is below alpha_min, and the bad splats are never culled."""
    rng = np.random.default_rng(3)
    n, h, w = 3000, 96, 128
    f32 = np.float32
    # covariance from random axes, 0.3..30 px, aspect up to 1:1000
    sig = rng.uniform(0.3, 30.0, n)
    aspect = np.where(rng.random(n) < 0.2, 1e-3, rng.uniform(0.2, 1.0, n))
    th_ = rng.uniform(0, np.pi, n)
    c, s = np.cos(th_), np.sin(th_)
    l1, l2 = sig ** 2, (sig * aspect) ** 2 + 0.3
    cov = np.stack([c * c * l1 + s * s * l2, c * s * (l1 - l2),
                    s * s * l1 + c * c * l2], 1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    conic = np.stack([cov[:, 2], -cov[:, 1], cov[:, 0]], 1) / det[:, None]
    centre = rng.uniform(-40, [w + 40, h + 40], (n, 2))
    op = rng.uniform(0.002, 1.0, n)
    radius = 3.0 * np.sqrt(np.stack([cov[:, 0], cov[:, 2]], 1))
    proj = stt.ops.projection.ProjectedGaussians(
        depth=torch.tensor(rng.uniform(1, 5, n), dtype=torch.float32),
        center_px=torch.tensor(centre.astype(f32)),
        conic=torch.tensor(conic.astype(f32)),
        radius_px=torch.tensor(radius.astype(f32)),
        color=torch.full((n, 3), 0.5), opacity=torch.tensor(op.astype(f32)),
        visible=torch.ones(n, dtype=torch.bool))
    # the splats the cull must leave alone: NaN/inf fields, far centres
    bad = {0: ("center_px", 0, np.nan), 1: ("conic", 1, np.inf),
           2: ("opacity", None, np.nan), 3: ("center_px", 1, 2e6)}
    for g, (field, col, v) in bad.items():
        t = getattr(proj, field)
        if col is None:
            t[g] = v
        else:
            t[g, col] = v
    cfg = stt.RenderConfig(tile_px=16, max_dup_factor=64.0, cull_pairs=True)
    rows = binning.cull_rows(proj, cfg.alpha_min)
    assert bool(torch.isinf(rows[list(bad), 3]).all())
    lay = binning.slot_layout(proj, h, w, cfg)
    assert int(lay.total[0]) <= lay.k_cap
    owners, tiles = _culled(lay)
    assert owners.numel() > 1000
    assert not set(owners.tolist()) & set(bad)
    alpha = _alpha_at_tile(proj, owners, tiles, lay, cfg)
    assert float(alpha.max()) < cfg.alpha_min


@pytest.mark.parametrize("fn", [expand_pair_keys, expand_pair_keys_plain],
                         ids=["wrapper", "plain"])
def test_cull_needs_the_tile_size(fn):
    """The cull tests a pair against its tile's pixel rectangle, so it takes
    the tile size from the caller every time: no default to go stale."""
    cfg = stt.RenderConfig(tile_px=16, cull_pairs=True)
    scene = stt.random_scene(64, seed=1, device="cpu")
    cam = stt.Camera.create(h=48, w=64, position=(0.0, 0.0, 4.0),
                            device="cpu")
    lay = binning.slot_layout(project_gaussians(scene, cam, cfg), 48, 64,
                              cfg)
    assert lay.tile_wh == (16, 16)
    args = (lay.first_slot, lay.tx0, lay.ty0, lay.span_w, lay.depth_bits,
            lay.total)
    kw = dict(k_cap=lay.k_cap, ntx=lay.tiles_x,
              num_tiles=lay.tiles_x * lay.tiles_y)
    with pytest.raises(ValueError, match="tile_wh"):
        fn(*args, **kw, cull=lay.cull)
    keys, _ = fn(*args, **kw, cull=lay.cull, tile_wh=lay.tile_wh)
    assert torch.equal(keys, lay.expand()[0])


@pytest.fixture(scope="module")
def big_splats():
    """Big splats (radii of tens of pixels) that overlap many tiles past
    their kill radius, with splat_tpu's cull_pairs image (Pallas kernels,
    interpret mode): no tile saturates, so every tile walks its range."""
    from splat_tpu.render.tiled import render_tiled as jax_render_tiled
    js = st.random_scene(256, seed=5, extent=0.8, scale_range=(0.3, 0.8))
    kw = dict(h=128, w=128, position=(0.0, 0.0, 3.0))
    cfg_kw = dict(chunk=64, max_dup_factor=16.0, cull_pairs=True)
    want = np.asarray(jax_render_tiled(js, st.Camera.create(**kw),
                                       st.RenderConfig(**cfg_kw),
                                       interpret=True))
    ts = stt.GaussianScene.from_numpy(js.to_numpy(), device="cpu")
    return ts, stt.Camera.create(**kw, device="cpu"), cfg_kw, want


def test_cull_pairs_image_equals_no_cull_and_splat_tpu(big_splats):
    ts, cam, cfg_kw, want = big_splats
    cfg = stt.RenderConfig(**cfg_kw)
    cfg0 = dataclasses.replace(cfg, cull_pairs=False)
    img, stats = stt.render_tiled(ts, cam, cfg, return_stats=True)
    img0, stats0 = stt.render_tiled(ts, cam, cfg0, return_stats=True)
    # pairs are culled; capacity and overflow count them, num_pairs not
    culled = int(stats0["num_pairs"]) - int(stats["num_pairs"])
    assert culled > 50
    assert int(stats["overflow"]) == int(stats0["overflow"]) == 0
    pairs = binning.count_pairs(project_gaussians(ts, cam, cfg), 128, 128,
                                cfg)[1]
    assert int(pairs) == int(stats0["num_pairs"])
    assert stt.pair_stats(ts, cam, cfg)["num_pairs"] == int(pairs)
    # every tile walks its whole range here, so the culled pairs, which no
    # pixel keeps, change nothing: the image, bit for bit
    bins0 = binning.build_tile_bins(project_gaussians(ts, cam, cfg0), 128,
                                    128, cfg0)
    _, walked = rasterize_tiles_plain(bins0, 128, 128, cfg0,
                                      return_walked=True)
    assert torch.equal(walked, (bins0.tile_end - bins0.tile_start).long())
    assert torch.equal(img, img0)
    # splat_tpu's cull (8-px quantized) keeps more pairs, but no pixel
    # keeps them either: the bar of test_torch_render.py
    assert stt.psnr(img, torch.from_numpy(want.copy())) >= 50.0


def test_cull_pairs_with_early_exits():
    """Where tiles saturate, removing dead pairs moves K2's batch
    boundaries, so a tile may stop a batch earlier or later: its pixels
    then differ by what they composite below T < alpha_min.  Tiles that
    walk their whole range match bit for bit."""
    ts = stt.random_scene(256, seed=5, extent=0.8, scale_range=(0.4, 1.0),
                          device="cpu")
    cam = stt.Camera.create(h=128, w=128, position=(0.0, 0.0, 2.5),
                            device="cpu")
    cfg0 = stt.RenderConfig(chunk=64, max_dup_factor=16.0)
    cfg = dataclasses.replace(cfg0, cull_pairs=True)
    proj = project_gaussians(ts, cam, cfg0)
    bins0 = binning.build_tile_bins(proj, 128, 128, cfg0)
    bins = binning.build_tile_bins(proj, 128, 128, cfg)
    assert int(bins.num_pairs) < int(bins0.num_pairs)
    img0, walked0 = rasterize_tiles_plain(bins0, 128, 128, cfg0,
                                          return_walked=True)
    img, walked = rasterize_tiles_plain(bins, 128, 128, cfg,
                                        return_walked=True)
    full = ((walked0 == (bins0.tile_end - bins0.tile_start))
            & (walked == (bins.tile_end - bins.tile_start)))
    assert 0 < int(full.sum()) < full.numel()
    diff = (img - img0).abs().amax(dim=-1)                # (H, W)
    tile = (torch.arange(128)[:, None] // 32) * 4 + torch.arange(128) // 32
    assert float(diff.max()) < cfg.alpha_min
    assert float(diff[full[tile]].max()) == 0.0
