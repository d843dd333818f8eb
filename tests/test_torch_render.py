"""The PyTorch port's whole inference slice — projection, binning, K1/K2
plain versions, tiled/dense renderers and the render() API — held against
splat_tpu's render_tiled (Pallas in interpret mode) and the NumPy oracle
on the same numpy scenes and poses (CPU)."""

import math

import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu.render.oracle import render_oracle
from splat_tpu.render.tiled import render_tiled as jax_render_tiled
from splat_tpu_torch.render import api
from splat_tpu_torch.render.tiled import CapacityOverflow

torch.set_num_threads(1)

DEMO_POS = (-0.57651054, 2.99040512, -0.03924271)

_CASES = {
    "random_default": ("random", dict(h=96, w=128, yaw=0.3), {}),
    "surface_rgba_bg": ("surface", dict(h=96, w=128, pitch=0.2),
                        dict(alpha_channel=True,
                             background=(0.1, 0.3, 0.6))),
    "random_sigma_inf": ("random", dict(h=80, w=112, yaw=-0.5),
                         dict(sigma_cutoff=math.inf)),
    "surface_ss2": ("surface", dict(h=64, w=64, yaw=0.9), dict(supersample=2)),
}


def _scene(kind, m):
    if kind == "surface":
        return m.surface_scene(2000, seed=4)
    return m.random_scene(2000, seed=8, extent=2.0, scale_range=(0.01, 0.1))


@pytest.mark.parametrize("case", list(_CASES))
def test_tiled_render_matches_jax_and_oracle(case):
    kind, cam_kw, cfg_kw = _CASES[case]
    cam_kw = dict(position=(0.0, -0.5, 4.0), **cam_kw)
    js = _scene(kind, st)
    ts = stt.GaussianScene.from_numpy(js.to_numpy(), device="cpu")
    jc, tc = st.Camera.create(**cam_kw), stt.Camera.create(**cam_kw, device="cpu")
    got = stt.render(ts, tc, stt.RenderConfig(chunk=64, **cfg_kw),
                     method="tiled").numpy()
    jcfg = st.RenderConfig(chunk=64, **cfg_kw)
    want = np.asarray(jax_render_tiled(js, jc, jcfg, interpret=True))
    gold = render_oracle(js, jc, jcfg)
    nch = 4 if cfg_kw.get("alpha_channel") else 3
    assert got.shape == want.shape == (cam_kw["h"], cam_kw["w"], nch)
    assert got[..., :3].mean() > 0.01         # something was drawn
    # the same pair sets and exit points; the port keeps exact depth
    # order and f32 colors where the TPU quantizes both
    assert stt.psnr(got, want) >= 50.0
    # the suite-wide golden-image bar (the oracle is RGB only)
    assert stt.psnr(got[..., :3], gold[..., :3]) >= 45.0


def test_dense_matches_oracle():
    js = st.naive_gaussians()
    ts = stt.naive_gaussians(device="cpu")
    for cfg_kw in ({}, dict(alpha_channel=True, supersample=2)):
        jc = st.Camera.create(h=72, w=128, position=DEMO_POS)
        tc = stt.Camera.create(h=72, w=128, position=DEMO_POS,
                               device="cpu")
        got = stt.render_dense(ts, tc, stt.RenderConfig(**cfg_kw)).numpy()
        gold = render_oracle(js, jc, st.RenderConfig(**cfg_kw))
        assert got.max() > 0.5              # the splats are drawn
        assert stt.psnr(got[..., :3], gold[..., :3]) >= 45.0


def test_render_auto_capacity_cache_and_retry():
    scene = stt.random_scene(5000, seed=3, extent=2.0,
                             scale_range=(0.01, 0.06), device="cpu")
    cam = stt.Camera.create(h=64, w=64, position=(0.0, 0.0, 4.0),
                            device="cpu")
    api._AUTO_CONFIG_CACHE.clear()
    img = stt.render(scene, cam)                 # auto -> tiled (N > 4096)
    ref = stt.render_dense(scene, cam)
    assert stt.psnr(img, ref) >= 45.0
    (key, (ref_w, cfg)), = api._AUTO_CONFIG_CACHE.items()
    assert ref_w() is scene.pack_device()     # keyed by the memoized pack
    stats = stt.pair_stats(scene, cam)
    assert stats["slots"] == stats["num_pairs"] > 0
    assert cfg.max_dup_factor >= stats["slots"] / 5000
    # a stale, too-small cached capacity is re-measured, not truncated
    small = stt.RenderConfig(max_dup_factor=0.05)
    api._AUTO_CONFIG_CACHE[key] = (ref_w, small)
    again = stt.render(scene, cam)
    np.testing.assert_array_equal(again.numpy(), img.numpy())
    assert api._AUTO_CONFIG_CACHE[key][1] is not small
    with pytest.raises(CapacityOverflow):
        stt.render(scene, cam, small, method="tiled")
    u8 = stt.render(scene, cam, method="tiled", as_uint8=True)
    assert u8.dtype == torch.uint8 and u8.shape == (64, 64, 3)


def test_empty_scene_is_background():
    empty = stt.GaussianScene.create(np.zeros((0, 3)), np.zeros((0, 4)),
                                     np.zeros((0, 3)), np.zeros(0),
                                     np.zeros((0, 16, 3)), device="cpu")
    cam = stt.Camera.create(h=16, w=24, device="cpu")
    cfg = stt.RenderConfig(alpha_channel=True, background=(0.2, 0.5, 0.7))
    img, stats = stt.render_tiled(empty, cam, cfg, return_stats=True)
    assert int(stats["num_pairs"]) == 0
    want = np.broadcast_to(np.float32([0.2, 0.5, 0.7, 0.0]), (16, 24, 4))
    np.testing.assert_array_equal(img.numpy(), want)
    np.testing.assert_array_equal(
        stt.render_dense(empty, cam, cfg).numpy(), want)
