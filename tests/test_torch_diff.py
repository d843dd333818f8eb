"""The PyTorch port's training path — the K3/K4 plain versions and
render_tiled_diff — held against splat_tpu/render/diff.py (Pallas in
interpret mode, as tests/test_diff.py runs it), against autograd through
the port's own K3 plain version, and against the port's dense renderer
(CPU).  Each JAX result is computed once per module."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_tpu as st
from splat_tpu.ops.projection import project_gaussians as jax_project
from splat_tpu.render import diff as jax_diff
from splat_tpu.render.binning import build_tile_bins as jax_bins
import splat_tpu_torch as stt
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.render import binning, diff, plan
from splat_tpu_torch.render.kernels import THREADS
from test_torch_raster import _port_bins

torch.set_num_threads(1)

LEAVES = ("means", "quats", "scales", "opacities", "sh")
H, W = 64, 96
CAM = dict(h=H, w=W, position=(0.0, 0.0, 4.0), yaw=0.2)
CFG = dict(max_dup_factor=8.0, background=(0.1, 0.2, 0.3))


def _light():
    return st.random_scene(600, seed=3, extent=2.0, scale_range=(0.02, 0.15))


def _deep(n=2000, opacity=0.999):
    """Nearly opaque, heavily overlapped: every tile saturates."""
    s = st.random_scene(n, seed=2, extent=2.0, scale_range=(0.3, 0.6))
    return dataclasses.replace(s, opacities=np.full((n,), opacity,
                                                    np.float32))


DEEP_CAM = dict(h=64, w=64, position=(0.0, 0.0, 1.5))


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / np.sqrt((a @ a) * (b @ b) + 1e-300))


def _leaf_scene(d):
    """A port scene whose five tensors are autograd leaves."""
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in d.items()}
    return stt.GaussianScene(**leaves), leaves


def _grads(render, d, cam, cfg, target):
    """Loss and per-leaf gradients of mean((render - target)^2)."""
    scene, leaves = _leaf_scene(d)
    loss = torch.mean((render(scene, cam, cfg) - target) ** 2)
    loss.backward()
    return float(loss.detach()), {
        k: (np.zeros(v.shape, np.float32) if v.grad is None
            else v.grad.numpy()) for k, v in leaves.items()}


def _replica(scene, cam, cfg):
    """render_tiled_diff's image through plain autograd of the binning
    and the K3 plain version: the exact function the K4 path
    differentiates."""
    proj = project_gaussians(scene, cam, cfg)
    bins = binning.build_tile_bins(proj, cam.h, cam.w, cfg)
    c, lt, _ = diff.rasterize_train_fwd_plain(bins, cam.h, cam.w, cfg)
    bg = torch.tensor(cfg.background)
    return torch.clamp(c + torch.exp(lt)[..., None] * bg, 0.0, 1.0)


@pytest.fixture(scope="module")
def jax_light():
    """JAX render_tiled_diff's image, loss and scene gradients (once)."""
    js = jax.tree.map(jnp.asarray, _light())
    cam = st.Camera.create(**CAM)
    cfg = st.RenderConfig(**CFG)
    target = np.random.default_rng(0).uniform(
        0, 1, (H, W, 3)).astype(np.float32)

    def loss(s):
        img = jax_diff.render_tiled_diff(s, cam, cfg)
        return jnp.mean((img - target) ** 2), img

    (value, img), g = jax.value_and_grad(loss, has_aux=True)(js)
    return {"img": np.asarray(img), "loss": float(value), "target": target,
            "grads": {k: np.asarray(getattr(g, k)) for k in LEAVES}}


_K3_CASES = {
    "light": (_light, CAM, dict(max_dup_factor=8.0)),
    "deep_exact_cut": (_deep, DEEP_CAM, dict(max_dup_factor=24.0)),
    "deep_sat_exit": (_deep, DEEP_CAM, dict(max_dup_factor=24.0,
                                            train_sat_exit=True)),
}


@pytest.mark.parametrize("case", list(_K3_CASES))
def test_k3_plain_matches_pallas_forward(case):
    """The K3 plain version on the JAX binning's own pair lists (decoded
    from its packed table) against the Pallas training forward."""
    make, cam_kw, cfg_kw = _K3_CASES[case]
    scene = jax.tree.map(jnp.asarray, make())
    cam = st.Camera.create(**cam_kw)
    jcfg = st.RenderConfig(**cfg_kw)
    h, w = cam_kw["h"], cam_kw["w"]
    jb = jax_bins(jax_project(scene, cam, jcfg), h, w, jcfg, interpret=True)
    assert int(jb.overflow) == 0
    c, lt, cut = jax_diff._fwd_raster(jb, h, w, jcfg, True)
    tb = _port_bins(jb)
    tc, tlt, tcut = diff.rasterize_train_fwd_plain(
        tb, h, w, stt.RenderConfig(**cfg_kw))
    np.testing.assert_array_equal(tcut.numpy(), np.asarray(cut))
    assert stt.psnr(tc.numpy(), np.asarray(c)) >= 60.0
    lt_j = np.asarray(lt)
    # logT in dB against its own range
    span = float(np.abs(lt_j).max())
    assert stt.psnr(tlt.numpy() / span, lt_j / span) >= 60.0
    _, _, _, nch = diff._windows(tb, jcfg.chunk)
    if case.startswith("deep"):
        assert bool((tcut.long() < nch).any()), "the cut never engaged"
    else:
        np.testing.assert_array_equal(tcut.numpy(), nch.numpy())


def test_render_tiled_diff_forward_matches_jax_and_render_tiled(jax_light):
    d = _light().to_numpy()
    scene = stt.GaussianScene.from_numpy(d, device="cpu")
    cam = stt.Camera.create(**CAM, device="cpu")
    cfg = stt.RenderConfig(**CFG)
    img = stt.render_tiled_diff(scene, cam, cfg)
    assert img.shape == (H, W, 3)
    assert stt.psnr(img.numpy(), jax_light["img"]) >= 60.0
    # render_tiled stops each tile at T < 1/255; the training walk does not
    assert stt.psnr(img.numpy(), stt.render_tiled(scene, cam, cfg)) >= 50.0


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradients_match_jax(jax_light, leaf):
    cam = stt.Camera.create(**CAM, device="cpu")
    loss, g = _grads(stt.render_tiled_diff, _light().to_numpy(), cam,
                     stt.RenderConfig(**CFG),
                     torch.tensor(jax_light["target"]))
    np.testing.assert_allclose(loss, jax_light["loss"], rtol=1e-4)
    # JAX quantizes colour and opacity to u16 straight-through (~1.5e-5)
    assert _cos(g[leaf], jax_light["grads"][leaf]) >= 0.999


_K4_CASES = {
    "default": (_light, CAM, dict(max_dup_factor=8.0)),
    "sigma_inf_clamp1": (_light, CAM, dict(max_dup_factor=8.0,
                                           sigma_cutoff=math.inf,
                                           alpha_clamp=1.0)),
    "deep_exact_cut": (_deep, DEEP_CAM, dict(max_dup_factor=24.0)),
    "deep_sat_exit_t16": (_deep, DEEP_CAM, dict(max_dup_factor=48.0,
                                                train_sat_exit=True,
                                                tile_px=16, chunk=64)),
}


@pytest.mark.parametrize("case", list(_K4_CASES))
def test_k4_plain_matches_autograd_of_k3_plain(case):
    """The same function both ways: K4's plain version against autograd
    through K3's plain version, per gaussian feature row."""
    make, cam_kw, cfg_kw = _K4_CASES[case]
    cfg = stt.RenderConfig(**cfg_kw)
    scene = stt.GaussianScene.from_numpy(make().to_numpy(), device="cpu")
    cam = stt.Camera.create(**cam_kw, device="cpu")
    h, w = cam.h, cam.w
    bins = binning.build_tile_bins(project_gaussians(scene, cam, cfg), h, w,
                                   cfg)
    assert int(bins.overflow) == 0
    # per-gaussian feature rows as a leaf, gathered into the pair table
    k = int(bins.num_pairs)
    rows = torch.zeros((binning.FEATURE_DIM, bins.num_gaussians))
    rows[:, bins.ranks[:k]] = bins.features[:, :k]
    rows.requires_grad_(True)
    leaf_bins = dataclasses.replace(bins,
                                    features=rows.index_select(1, bins.ranks))
    rng = np.random.default_rng(1)
    g_c = torch.tensor(rng.normal(size=(h, w, 3)).astype(np.float32))
    g_lt = torch.tensor(rng.normal(size=(h, w)).astype(np.float32))
    c, lt, cut = diff.rasterize_train_fwd_plain(leaf_bins, h, w, cfg)
    ((c * g_c).sum() + (lt * g_lt).sum()).backward()
    want = rows.grad[:len(diff.GRAD_COLUMNS)].T.numpy()
    got = diff.rasterize_train_bwd_plain(bins, g_c, g_lt, lt.detach(), cut,
                                         h, w, cfg).numpy()
    assert np.abs(want).max() > 0
    for q, name in enumerate(diff.GRAD_COLUMNS):
        scale = np.abs(want[:, q]).max() + 1e-30
        assert np.abs(got[:, q] - want[:, q]).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("bad", [
    dict(render_mode="depth"),              # needs an explicit range
    dict(binning_key="rank"),
    dict(cull_pairs=True),
    dict(subtile_exit=True),
    dict(transmit_mxu=False),
], ids=["depth_no_range", "rank", "cull_pairs", "subtile_exit",
        "transmit_vpu"])
def test_config_restrictions(bad):
    scene = stt.random_scene(10, seed=0, device="cpu")
    cam = stt.Camera.create(h=32, w=32, position=(0.0, 0.0, 4.0),
                            device="cpu")
    with pytest.raises(NotImplementedError):
        stt.render_tiled_diff(scene, cam, stt.RenderConfig(**bad))
    # depth mode with an explicit range is supported
    img = stt.render_tiled_diff(scene, cam, stt.RenderConfig(
        render_mode="depth", depth_range=(1.0, 5.0)))
    assert bool(torch.isfinite(img).all())


def test_empty_scene_alpha_channel_and_supersample():
    empty = stt.random_scene(0, seed=0, device="cpu")
    cam = stt.Camera.create(h=32, w=32, position=(0.0, 0.0, 4.0),
                            device="cpu")
    img = stt.render_tiled_diff(empty, cam, stt.RenderConfig())
    assert img.shape == (32, 32, 3) and float(img.abs().max()) == 0.0
    scene = stt.GaussianScene.from_numpy(_light().to_numpy(), device="cpu")
    cfg = stt.RenderConfig(max_dup_factor=8.0, alpha_channel=True,
                           supersample=2)
    img = stt.render_tiled_diff(scene, cam, cfg)
    assert img.shape == (32, 32, 4)
    assert stt.psnr(img, stt.render_tiled(scene, cam, cfg)) >= 50.0


def _cut_engages_and_matches_uncut():
    """tests/test_diff.py:276: the exact cut skips windows whose every
    contribution is an exact zero: the image equals the uncut walk's, and
    the gradients move only within logT reconstruction rounding."""
    d = _deep().to_numpy()
    cam = stt.Camera.create(**DEEP_CAM, device="cpu")
    cfg = stt.RenderConfig(max_dup_factor=24.0, alpha_channel=True)
    scene = stt.GaussianScene.from_numpy(d, device="cpu")
    bins = binning.build_tile_bins(project_gaussians(scene, cam, cfg),
                                   cam.h, cam.w, cfg)
    _, _, cut = diff.rasterize_train_fwd(bins, cam.h, cam.w, cfg)
    _, _, _, nch = diff._windows(bins, cfg.chunk)
    assert bool((cut.long() < nch).any()), "fixture failed to engage the cut"
    tgt = torch.full((cam.h, cam.w, 4), 0.3)
    img_cut = stt.render_tiled_diff(scene, cam, cfg)
    img_full = stt.render_tiled_diff(scene, cam, cfg,
                                     sat_cut_log=-math.inf)
    np.testing.assert_array_equal(img_cut.numpy(), img_full.numpy())
    _, g_cut = _grads(stt.render_tiled_diff, d, cam, cfg, tgt)
    _, g_full = _grads(
        lambda s, c, f: stt.render_tiled_diff(s, c, f,
                                              sat_cut_log=-math.inf),
        d, cam, cfg, tgt)
    for name in LEAVES:
        scale = np.abs(g_full[name]).max() + 1e-20
        assert np.abs(g_cut[name] - g_full[name]).max() / scale < 1e-5, name


def _train_sat_exit_truncates_and_bounds_error():
    """tests/test_diff.py:316: the exit at T < alpha_min cuts earlier than
    the exact cut, its image stays within a few alpha_min of the full
    walk, and its gradients keep their direction."""
    d = _deep(opacity=0.9).to_numpy()
    cam = stt.Camera.create(**DEEP_CAM, device="cpu")
    cfg_full = stt.RenderConfig(max_dup_factor=24.0)
    cfg_exit = dataclasses.replace(cfg_full, train_sat_exit=True)
    scene = stt.GaussianScene.from_numpy(d, device="cpu")
    bins = binning.build_tile_bins(project_gaussians(scene, cam, cfg_exit),
                                   cam.h, cam.w, cfg_exit)
    _, _, cut_x = diff.rasterize_train_fwd(bins, cam.h, cam.w, cfg_exit)
    _, _, cut_f = diff.rasterize_train_fwd(bins, cam.h, cam.w, cfg_full)
    assert bool((cut_x < cut_f).any())
    img_x = stt.render_tiled_diff(scene, cam, cfg_exit)
    img_f = stt.render_tiled_diff(scene, cam, cfg_full)
    assert float((img_x - img_f).abs().max()) <= 4.0 * cfg_full.alpha_min
    tgt = torch.full((cam.h, cam.w, 3), 0.3)
    _, g_x = _grads(stt.render_tiled_diff, d, cam, cfg_exit, tgt)
    _, g_f = _grads(stt.render_tiled_diff, d, cam, cfg_full, tgt)
    for name in ("means", "scales", "opacities", "sh"):
        assert _cos(g_x[name], g_f[name]) >= 0.99, name


def _depth_grads_match_dense():
    """tests/test_diff.py:400: depth supervision through the tiled path
    agrees with autograd through the dense renderer."""
    d = st.random_scene(40, seed=2).to_numpy()
    cam = stt.Camera.create(h=48, w=48, position=(0.0, 0.0, 4.0),
                            device="cpu")
    cfg = stt.RenderConfig(sh_degree=0, render_mode="depth",
                           depth_range=(1.0, 7.0), max_dup_factor=16.0,
                           alpha_channel=True)
    tgt = torch.full((48, 48, 4), 0.3)
    _, gt = _grads(stt.render_tiled_diff, d, cam, cfg, tgt)
    _, gd = _grads(stt.render_dense, d, cam, cfg, tgt)
    for name in ("means", "scales", "opacities"):
        assert _cos(gt[name], gd[name]) > 0.995, name
    assert np.abs(gt["means"]).max() > 0


def _gradients_survive_transmittance_underflow():
    """tests/test_diff.py:485: hundreds of stacked near-opaque splats
    drive T below the f32 range; log-space reconstruction keeps the front
    splats' gradients, equal to autograd through the plain forward."""
    n = 160
    rng = np.random.default_rng(0)
    d = st.random_scene(n, seed=2).to_numpy()
    d.update(means=rng.normal(0, 0.05, (n, 3)).astype(np.float32),
             opacities=np.full((n,), 0.95, np.float32),
             scales=np.full((n, 3), 0.3, np.float32))
    cam = stt.Camera.create(h=32, w=32, position=(0.0, 0.0, 3.0),
                            device="cpu")
    cfg = stt.RenderConfig(max_dup_factor=float(2 * 32 * 32))
    scene = stt.GaussianScene.from_numpy(d, device="cpu")
    img4 = stt.render_tiled_diff(scene, cam, dataclasses.replace(
        cfg, alpha_channel=True))
    assert float((1.0 - img4[..., 3]).min()) == 0.0
    tgt = torch.full((32, 32, 3), 0.4)
    _, gt = _grads(stt.render_tiled_diff, d, cam, cfg, tgt)
    _, gr = _grads(_replica, d, cam, cfg, tgt)
    for name in ("means", "opacities", "sh"):
        scale = np.abs(gr[name]).max() + 1e-20
        assert np.isfinite(gt[name]).all()
        assert np.abs(gt[name] - gr[name]).max() / scale < 1e-3, name
    depth = project_gaussians(scene, cam, cfg).depth.numpy()
    assert np.abs(gt["sh"][int(np.argmin(depth))]).max() > 0


def _grads_finite_with_cropped_boundary_tiles():
    """tests/test_diff.py:536: h not a multiple of the tile height."""
    n = 160
    rng = np.random.default_rng(1)
    d = st.random_scene(n, seed=3).to_numpy()
    d.update(means=rng.normal(0, 0.05, (n, 3)).astype(np.float32),
             opacities=np.full((n,), 0.99, np.float32),
             scales=np.full((n, 3), 6.0, np.float32))
    cam = stt.Camera.create(h=40, w=32, position=(0.0, 0.0, 3.0),
                            device="cpu")
    cfg = stt.RenderConfig(max_dup_factor=8.0)
    _, g = _grads(stt.render_tiled_diff, d, cam, cfg,
                  torch.full((40, 32, 3), 0.4))
    for name in LEAVES:
        assert np.isfinite(g[name]).all(), name
    assert np.abs(g["sh"]).max() > 0


def _grads_finite_at_alpha_exactly_one():
    """tests/test_diff.py:566: alpha_clamp=1.0 with opacity 1: pixels where
    exp(power) rounds to 1 see alpha == 1 exactly."""
    d = st.random_scene(4, seed=5).to_numpy()
    d.update(means=np.zeros((4, 3), np.float32),
             opacities=np.ones((4,), np.float32),
             scales=np.full((4, 3), 600.0, np.float32))
    cam = stt.Camera.create(h=32, w=32, position=(0.0, 0.0, 3.0),
                            device="cpu")
    cfg = stt.RenderConfig(alpha_clamp=1.0, max_dup_factor=8.0)
    scene = stt.GaussianScene.from_numpy(d, device="cpu")
    assert float(stt.render_tiled_diff(scene, cam, cfg).max()) > 0
    _, g = _grads(stt.render_tiled_diff, d, cam, cfg,
                  torch.full((32, 32, 3), 0.2))
    for name in LEAVES:
        assert np.isfinite(g[name]).all(), name


_REFERENCE_CASES = {
    "exact_cut": _cut_engages_and_matches_uncut,
    "train_sat_exit": _train_sat_exit_truncates_and_bounds_error,
    "depth_vs_dense": _depth_grads_match_dense,
    "transmittance_underflow": _gradients_survive_transmittance_underflow,
    "cropped_boundary_tiles": _grads_finite_with_cropped_boundary_tiles,
    "alpha_exactly_one": _grads_finite_at_alpha_exactly_one,
}


@pytest.mark.parametrize("case", list(_REFERENCE_CASES))
def test_reference_cases(case):
    """The cases of tests/test_diff.py, run on the port."""
    _REFERENCE_CASES[case]()


@pytest.mark.parametrize("ppt", [1, 2, 4, 16])
def test_split_plan_covers_each_pixel_once(ppt):
    """The kernels' work list: every tile is taken, heavy tiles by
    ``_split(ppt)`` blocks whose pixel groups cover each of the tile's
    pixel slots exactly once (each block walks all the tile's pairs for
    its pixels, so every walked (pixel, pair) is computed once)."""
    rng = np.random.default_rng(ppt)
    walk = torch.tensor(rng.integers(0, 3 * diff.SPLIT_MIN_PAIRS, 60))
    walk[:3] = diff.SPLIT_MIN_PAIRS + 1         # just over the threshold
    split = diff._split(ppt)
    order, nheavy = diff._tile_plan(walk, split, slots=1000)
    assert order.dtype == nheavy.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(walk.numel()))
    heavy = walk > diff.SPLIT_MIN_PAIRS
    assert int(nheavy) == (int(heavy.sum()) if split > 1 else 0)
    # heavy tiles first, each group longest first to within a bucket
    sorted_walk = walk[order.long()]
    assert bool((heavy[order.long()][:int(nheavy)]).all())
    for part in (sorted_walk[:int(nheavy)], sorted_walk[int(nheavy):]):
        assert bool((part.diff() <= int(walk.max())
                     // (plan.PLAN_BUCKETS - 1) + 1).all())
    slots = THREADS * ppt
    covered = {t: [] for t in range(walk.numel())}
    for tile, group, groups in diff._block_work(order, nheavy, split):
        assert groups == (split if bool(heavy[tile]) and split > 1 else 1)
        per = slots // groups                   # ppt / groups a thread
        covered[tile] += range(group * per, (group + 1) * per)
    for t, pix in covered.items():
        assert sorted(pix) == list(range(slots)), t


def test_split_plan_adapts_to_the_frame():
    """A tile is split only where it walks more than the frame's walk
    spread over the resident blocks: a balanced frame splits nothing."""
    walk = torch.full((100,), 5000, dtype=torch.int64)
    walk[7] = 9000
    _, nheavy = diff._tile_plan(walk, 4, slots=264)     # mean 1909
    assert int(nheavy) == 100
    _, nheavy = diff._tile_plan(walk, 4, slots=60)      # mean 8400
    assert int(nheavy) == 1
    _, nheavy = diff._tile_plan(walk, 4, slots=50)      # mean 10080
    assert int(nheavy) == 0
