"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import math

import pytest
import torch

import splat_tpu_torch as stt
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.render import binning
from splat_tpu_torch.render.expand import (expand_pair_keys,
                                           expand_pair_keys_plain)
from splat_tpu_torch.render.diff import (SPLIT_MIN_PAIRS, _windows,
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
], ids=["default", "t16_rgba", "t32x16_inf", "t64", "t48x40"])
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
    cfg_kw, kind = _TRAIN_CASES[case]
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
