"""The projection front end's plain version (``render/front.py``) on the CPU.

``project_front_plain`` must give, bit for bit, what the frame's chain of
PyTorch ops gave before it was one function: ``project_gaussians``, the
quantized radii and tile spans, the cull rows and the 11 feature rows; its
count-only form what ``count_pairs`` gives.  The renders and pair counts
built on it must equal those of that chain, and training's projection must
stay on autograd.  The kernel is held to this version on the card
(``tests/test_torch_cuda_front.py``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import splat_tpu_torch as stt
from splat_tpu_torch import train
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.render import binning, front
from splat_tpu_torch.render.diff import render_tiled_diff
from splat_tpu_torch.render.kernels import rasterize_tiles

H, W = 96, 128


def odd_scene(n=2000, seed=3, device="cpu"):
    """A cloud with SH of every band, some splats behind the camera, some
    below alpha_min, some with NaN centres or degenerate scales."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.005), np.log(0.3),
                                (n, 3))).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, n).astype(np.float32)
    sh = rng.normal(0.0, 0.4, (n, 16, 3)).astype(np.float32)
    means[:40, 2] = 6.0                       # behind the camera
    means[40:60, 0] = np.nan                  # NaN centres
    opac[60:90] = 0.001                       # below alpha_min
    scales[90:110] = 0.0                      # degenerate covariance
    means[110:130] *= 40.0                    # far off screen
    quats[130:140] = 0.0                      # zero quaternion
    return stt.GaussianScene.create(means, quats, scales, opac, sh,
                                    device=device)


def camera(kind, h=H, w=W, device="cpu"):
    """An orbit camera off the axis, or an SE(3) camera at its pose with
    unequal focals and an off-centre principal point."""
    cam = stt.Camera.create(h=h, w=w, position=(0.3, -0.4, 4.0), yaw=0.35,
                            pitch=0.2, device=device)
    if kind == "orbit":
        return cam
    s = w / W
    return stt.SE3Camera.create(h=h, w=w, view=cam.view_matrix(),
                                fx=70.0 * s, fy=83.5 * s, cx=60.25 * s,
                                cy=51.0 * s, device=device)


def chain_front(scene, cam, cfg):
    """The frame's per-gaussian chain as it was written out before the
    projection front end: projection, quantized radii, spans, cull, rows."""
    proj = project_gaussians(scene, cam, cfg)
    ntx, nty = -(-cam.w // cfg.tile_w), -(-cam.h // cfg.tile_h)
    rbits = binning.quantize_radius_bits(proj.radius_px[:, 0],
                                         proj.radius_px[:, 1], proj.visible)
    tx0, ty0, sw, counts = binning.tile_spans(
        proj.center_px[:, 0], proj.center_px[:, 1], rbits, cfg.tile_w,
        cfg.tile_h, ntx, nty)
    rx, ry, _ = binning.decode_radius_bits(rbits)
    color = torch.clamp(proj.color, 0.0, 1.0)
    feats = torch.stack([
        proj.center_px[:, 0], proj.center_px[:, 1],
        -0.5 * proj.conic[:, 0], -proj.conic[:, 1], -0.5 * proj.conic[:, 2],
        color[:, 0], color[:, 1], color[:, 2], proj.opacity,
        rx * rx, ry * ry])
    return dict(rbits=rbits, tx0=tx0, ty0=ty0, span_w=sw, counts=counts,
                depth_bits=proj.depth.contiguous().view(torch.int32),
                features=feats,
                cull=(binning.cull_rows(proj, cfg.alpha_min)
                      if cfg.cull_pairs else None),
                num_visible=proj.visible.sum())


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bit_equal(got: binning.GaussianFront, want: dict):
    for name, w in want.items():
        g = getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(bits(g), bits(w)), name


FLAGS = {
    "default": dict(),
    "cov3d_transpose": dict(cov3d_transpose=True),
    "sh_stale_eye": dict(sh_stale_eye=True),
    "loose_radius": dict(tight_radius=False),
    "sigma_inf": dict(sigma_cutoff=math.inf),
    "cull": dict(cull_pairs=True),
    "sh0": dict(sh_degree=0),
    "sh1": dict(sh_degree=1),
    "sh2": dict(sh_degree=2),
    "depth": dict(render_mode="depth"),
    "depth_range": dict(render_mode="depth", depth_range=(2.0, 7.0)),
    "t16": dict(tile_px=16),
    "t24x16": dict(tile_px=24, tile_py=16, cull_pairs=True),
    "lowpass_alpha": dict(lowpass=0.1, alpha_min=0.02, sigma_cutoff=2.5),
}


@pytest.fixture(scope="module")
def scene():
    return odd_scene()


@pytest.mark.parametrize("kind", ["orbit", "se3"])
@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
def test_front_plain_equals_the_chain(scene, flags, kind):
    cfg = stt.RenderConfig(**FLAGS[flags])
    cam = camera(kind)
    want = chain_front(scene, cam, cfg)
    assert 0 < int(want["num_visible"]) < scene.num_gaussians - 100
    for sc in (scene, scene.pack_device()):
        assert_bit_equal(front.project_front(sc, cam, cfg), want)


@pytest.mark.parametrize("flags", ["default", "loose_radius", "sigma_inf",
                                   "t24x16", "lowpass_alpha", "cull"])
@pytest.mark.parametrize("kind", ["orbit", "se3"])
def test_front_count_only_equals_count_pairs(scene, flags, kind):
    cfg = stt.RenderConfig(**FLAGS[flags])
    cam = camera(kind)
    want = torch.stack(binning.count_pairs(
        project_gaussians(scene, cam, cfg), H, W, cfg))
    got = front.project_front(scene.pack_device(), cam, cfg,
                              count_only=True)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert int(want[1]) > 0


@pytest.mark.parametrize("flags", ["default", "cull", "depth", "sigma_inf"])
def test_render_tiled_equals_the_chain(scene, flags):
    cfg = stt.RenderConfig(**FLAGS[flags])
    cam = camera("orbit")
    img, stats = stt.render_tiled(scene.pack_device(), cam, cfg,
                                  return_stats=True)
    proj = project_gaussians(scene, cam, cfg)
    bins = binning.build_tile_bins(proj, H, W, cfg)
    want = rasterize_tiles(bins, H, W, cfg)
    assert torch.equal(img, want)
    assert int(stats["num_pairs"]) == int(bins.num_pairs) > 0
    assert int(stats["overflow"]) == int(bins.overflow) == 0
    assert int(stats["visible"]) == int(proj.visible.sum())


def test_pair_stats_and_view_pairs_equal_count_pairs(scene):
    cfg = stt.RenderConfig()
    cams = [camera("orbit"), camera("se3")]
    want = [binning.count_pairs(project_gaussians(scene, c, cfg), H, W, cfg)
            for c in cams]
    stats = stt.pair_stats(scene, cams[0], cfg)
    assert (stats["visible"], stats["num_pairs"]) == tuple(
        int(x) for x in want[0])
    for sc in (scene, scene.pack_device()):
        got = train._view_pairs(sc, cams, cfg)
        assert got.dtype == torch.int64
        assert got.tolist() == [int(p) for _, p in want]
    # supersampled views count at the scaled resolution
    ss = dataclasses.replace(cfg, supersample=2)
    big = cams[0].scaled(2)
    assert train._view_pairs(scene, cams[:1], ss).tolist() == [int(
        binning.count_pairs(project_gaussians(scene, big, ss), 2 * H, 2 * W,
                            ss)[1])]


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("kind", ["orbit", "se3"])
def test_camera_record_equals_the_camera(kind, stale, monkeypatch):
    """The kernel's 20 floats are the plain projection's camera, bit for
    bit, with the eye computed once for the view and the SH eye."""
    cam = camera(kind)
    want = torch.cat([cam.view_matrix()[:3].reshape(12),
                      torch.stack(cam.intrinsics_px()),
                      cam.sh_eye(stale).reshape(3), cam.znear.reshape(1)])
    eyes = []
    real = type(cam).eye
    monkeypatch.setattr(type(cam), "eye",
                        lambda self: eyes.append(1) or real(self))
    got = cam.record(stale)
    assert got.dtype == torch.float32 and got.shape == (20,)
    assert torch.equal(bits(got), bits(want))
    assert len(eyes) == 1


@pytest.fixture
def calls(monkeypatch):
    """Counts of project_front_plain's calls, by mode."""
    seen = {"frame": 0, "count": 0}
    plain = front.project_front_plain

    def spy(scene, camera, config, *, count_only=False):
        seen["count" if count_only else "frame"] += 1
        return plain(scene, camera, config, count_only=count_only)

    monkeypatch.setattr(front, "project_front_plain", spy)
    return seen


def test_training_projection_stays_on_autograd(scene, calls):
    cfg = stt.RenderConfig()
    cam = camera("orbit")
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in ("means", "quats", "scales", "opacities", "sh")}
    img = render_tiled_diff(stt.GaussianScene(**leaves), cam, cfg)
    (img * torch.linspace(0.5, 1.5, img.numel()).reshape(img.shape)
     ).sum().backward()
    assert calls == {"frame": 0, "count": 0}
    for name, leaf in leaves.items():
        g = leaf.grad[140:]                  # past the odd splats
        assert torch.isfinite(g).all() and g.abs().sum() > 0, name
    # the frame goes through the front end, once
    stt.render_tiled(scene, cam, cfg)
    assert calls == {"frame": 1, "count": 0}


def test_fit_demand_pass_counts_each_view(calls):
    scene = stt.random_scene(1500, seed=2, extent=1.5, device="cpu")
    cams = [stt.Camera.create(h=48, w=64, position=(0.0, 0.0, 4.0), yaw=y,
                              device="cpu") for y in (0.0, 0.3)]
    targets = torch.stack([stt.render_dense(scene, c) for c in cams])
    cfg = stt.RenderConfig(max_dup_factor=8.0)
    res = stt.fit(scene, cams, targets, steps=2, lr=1e-3, config=cfg,
                  method="tiled")
    assert torch.isfinite(res.losses).all()
    # the capacity audit (2 views) and each step's demand pass (2 views)
    assert calls == {"frame": 0, "count": 2 + 2 * 2}
