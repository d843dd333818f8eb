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
from splat_tpu_torch.render import binning, emulate, plan
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
    dict(chunk=1100),        # a batch above 48 KB of shared memory
], ids=["default", "t16_rgba", "t32x16_inf", "t64", "t48x40", "chunk1100"])
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
    # by the pairs held, K4's by what the cut left of each walk
    ppt = next(q for q in (1, 2, 4, 8, 16)
               if q * plan.THREADS >= cfg.tile_w * cfg.tile_h)
    left = _walk_end(bins, cfg.chunk, cut) - bins.tile_start
    for fn, walk in ((rasterize_train_fwd, pairs),
                     (rasterize_train_bwd, left)):
        assert int(fn.split_tiles) == int(plan._tile_plan(
            walk, plan._split(ppt), plan._slots(dev))[1])
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
