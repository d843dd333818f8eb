"""The PyTorch port's scene, fixtures, camera, PLY I/O and projection held
against splat_tpu on the same numpy inputs (CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu.ops.projection import project_gaussians as jax_project
from splat_tpu_torch.ops.projection import project_gaussians

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")

DEMO_POS = (-0.57651054, 2.99040512, -0.03924271)


def _cams(**kw):
    return st.Camera.create(**kw), stt.Camera.create(**kw, device="cpu")


def test_import_pulls_in_no_jax():
    code = ("import sys, splat_tpu_torch, splat_tpu_torch.render.diff, "
            "splat_tpu_torch.train, splat_tpu_torch.utils.benchmark; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'splat_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("make", [
    lambda m, **kw: m.naive_gaussians(**kw),
    lambda m, **kw: m.random_scene(300, seed=5, extent=2.0, **kw),
    lambda m, **kw: m.surface_scene(400, seed=2, **kw),
], ids=["naive", "random", "surface"])
def test_fixtures_bit_equal(make):
    want = make(st).to_numpy()
    got = make(stt, device="cpu").to_numpy()
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_scene_numpy_round_trip():
    d = st.random_scene(50, seed=1).to_numpy()
    scene = stt.GaussianScene.from_numpy(d, device="cpu")
    assert len(scene) == 50 and scene.sh.shape == (50, 16, 3)
    for k, v in scene.to_numpy().items():
        np.testing.assert_array_equal(v, d[k])
    with pytest.raises(ValueError):
        stt.GaussianScene.create(d["means"], d["quats"][:3], d["scales"],
                                 d["opacities"], d["sh"], device="cpu")


@pytest.mark.parametrize("yaw,pitch", [(0.0, 0.0), (0.7, 0.3), (-2.1, -0.4)])
def test_camera_matrices(yaw, pitch):
    jc, tc = _cams(h=90, w=160, position=(0.3, -1.0, 3.5), yaw=yaw,
                   pitch=pitch)
    # f32 matrices from the same float32 formulas: atol 1e-6
    np.testing.assert_allclose(tc.view_matrix().numpy(),
                               np.asarray(jc.view_matrix()), atol=1e-6)
    np.testing.assert_allclose(tc.projection_matrix().numpy(),
                               np.asarray(jc.projection_matrix()), atol=1e-6)
    np.testing.assert_allclose(tc.sh_eye(True).numpy(),
                               np.asarray(jc.sh_eye(True)), atol=1e-6)
    for a, b in zip(tc.intrinsics_px(), jc.intrinsics_px()):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6)
    assert (tc.scaled(2).h, tc.scaled(2).w) == (180, 320)


def test_config_mirrors_reference_validation():
    assert stt.RenderConfig().block_shape == st.RenderConfig().block_shape
    for kw in ({"sh_degree": 4}, {"tile_px": 12}, {"binning_key": "x"},
               {"supersample": 0}, {"render_mode": "x"},
               {"depth_range": (2.0, 1.0)},
               {"sigma_cutoff": float("inf"), "tight_radius": False}):
        with pytest.raises(ValueError):
            st.RenderConfig(**kw)
        with pytest.raises(ValueError):
            stt.RenderConfig(**kw)
    # the two knobs that change how K1 and K2 walk their pairs construct
    # in both packages (render_tiled_diff refuses them in both)
    for kw in ({"subtile_exit": True, "subtile_heavy_pairs": 0},
               {"cull_pairs": True}):
        got, want = stt.RenderConfig(**kw), st.RenderConfig(**kw)
        for k, v in kw.items():
            assert getattr(got, k) == getattr(want, k) == v


@pytest.mark.parametrize("tile_px, tile_py, chunk, ok", [
    (32, 0, 128, True), (64, 0, 256, True), (64, 128, 128, True),
    (128, 0, 2048, True), (256, 128, 128, True), (256, 0, 128, False),
    (512, 128, 64, False), (16, 8, 0, False)])
def test_config_kernel_limits_agree(tile_px, tile_py, chunk, ok):
    """One rule for tile size and chunk on every device: the config the
    card's wrappers would refuse fails at construction, on the CPU too.
    splat_tpu accepts the larger tiles (a documented difference)."""
    from splat_tpu_torch.config import check_kernel_limits
    from splat_tpu_torch.render import kernels
    kw = dict(tile_px=tile_px, tile_py=tile_py, chunk=chunk)
    tw, th = tile_px, tile_py or tile_px
    if ok:
        check_kernel_limits(tw, th, chunk)
        cfg = stt.RenderConfig(**kw)
        # the launch the card's wrappers make: pixels a thread, blocks a
        # tile (several only at 16 a thread, at most a cluster of 8)
        ppt, groups = kernels._ppt(cfg)
        assert ppt * 256 * groups >= tw * th
        assert groups <= 8 and (groups == 1 or (ppt == 16 and tw * th > 4096))
        return
    with pytest.raises(ValueError):
        check_kernel_limits(tw, th, chunk)
    with pytest.raises(ValueError):
        stt.RenderConfig(**kw)
    if chunk >= 1:
        st.RenderConfig(**kw)


def _op_inputs(n=64, seed=4):
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.01, 0.3, (n, 3)).astype(np.float32)
    means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    sh = rng.normal(0.0, 0.5, (n, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return dict(quats=quats, scales=scales, means=means, sh=sh, dirs=dirs,
                rgb=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32))


def _op_pairs():
    """(name, JAX call, port call) on the dict of numpy inputs."""
    from splat_tpu.ops import projection as jp, sh as jsh, transforms as jt
    from splat_tpu_torch.ops import (projection as tp, sh as tsh,
                                     transforms as tt)
    t = torch.from_numpy
    jcam, tcam = _cams(h=64, w=96, position=(0.2, -0.3, 3.0), yaw=0.4)
    jview, tview = jcam.view_matrix(), tcam.view_matrix()
    f = 80.0
    pairs = [(f"eval_sh_deg{d}",
              lambda i, d=d: jsh.eval_sh(i["sh"], i["dirs"], d),
              lambda i, d=d: tsh.eval_sh(t(i["sh"]), t(i["dirs"]), d))
             for d in range(4)]
    pairs += [
        ("rgb_to_dc", lambda i: jsh.rgb_to_dc(i["rgb"]),
         lambda i: tsh.rgb_to_dc(t(i["rgb"]))),
        ("compute_cov3d", lambda i: jt.compute_cov3d(i["quats"], i["scales"]),
         lambda i: tt.compute_cov3d(t(i["quats"]), t(i["scales"]))),
        ("compute_cov3d_packed",
         lambda i: jt.compute_cov3d_packed(i["quats"], i["scales"]),
         lambda i: tt.compute_cov3d_packed(t(i["quats"]), t(i["scales"]))),
        ("pack_unpack", lambda i: jt.pack_cov3d(jt.unpack_cov3d(
            jt.compute_cov3d_packed(i["quats"], i["scales"]))),
         lambda i: tt.pack_cov3d(tt.unpack_cov3d(
             tt.compute_cov3d_packed(t(i["quats"]), t(i["scales"]))))),
        ("ewa_project", lambda i: jp.ewa_project(
            i["means"], jt.compute_cov3d(i["quats"], i["scales"]), jview,
            1.0, 1.0, f, 0.3),
         lambda i: tp.ewa_project(
             t(i["means"]), tt.compute_cov3d(t(i["quats"]), t(i["scales"])),
             tview, 1.0, 1.0, f, 0.3)),
        ("ewa_project_packed", lambda i: jp.ewa_project_packed(
            i["means"], jt.compute_cov3d_packed(i["quats"], i["scales"]),
            jview, f, 0.3),
         lambda i: tp.ewa_project_packed(
             t(i["means"]), tt.compute_cov3d_packed(t(i["quats"]),
                                                    t(i["scales"])),
             tview, f, 0.3)),
    ]
    return pairs


@pytest.mark.parametrize("idx", range(10))
def test_per_gaussian_ops_match_jax(idx):
    """The public per-gaussian ops against splat_tpu's on seeded inputs:
    the same f32 formulas in another order, rtol 1e-5 (atol 1e-6 where a
    term cancels to ~0)."""
    name, jfn, tfn = _op_pairs()[idx]
    inputs = _op_inputs(seed=idx)
    want = jfn(inputs)
    got = tfn(inputs)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_fit_result_exported():
    assert stt.FitResult is stt.train.FitResult
    assert "FitResult" in stt.__all__


_PROJ_CASES = {
    "naive": (lambda m: m.naive_gaussians(),
              dict(h=144, w=256, position=DEMO_POS), {}),
    "random_orbit": (lambda m: m.random_scene(1500, seed=3, extent=2.0,
                                              scale_range=(0.01, 0.1)),
                     dict(h=96, w=128, position=(0.0, 0.0, 4.0), yaw=0.6,
                          pitch=0.25), {}),
    "surface_quirks": (lambda m: m.surface_scene(1500, seed=1),
                       dict(h=96, w=128, position=(0.5, -1.0, 4.0),
                            yaw=-0.4, pitch=0.2),
                       dict(cov3d_transpose=True, sh_stale_eye=True,
                            sh_degree=2)),
    "random_inf_depth": (lambda m: m.random_scene(800, seed=9, extent=2.0),
                         dict(h=64, w=96, position=(0.0, 0.0, 3.0)),
                         dict(sigma_cutoff=float("inf"),
                              render_mode="depth", lowpass=0.1)),
}


@pytest.mark.parametrize("case", list(_PROJ_CASES))
def test_project_gaussians_matches_jax(case):
    make, cam_kw, cfg_kw = _PROJ_CASES[case]
    js = make(st)
    ts = stt.GaussianScene.from_numpy(js.to_numpy(), device="cpu")
    jc, tc = _cams(**cam_kw)
    jp = jax_project(js, jc, st.RenderConfig(**cfg_kw))
    tp = project_gaussians(ts, tc, stt.RenderConfig(**cfg_kw))
    vis = np.asarray(jp.visible)
    np.testing.assert_array_equal(tp.visible.numpy(), vis)
    assert vis.any()
    # f32 arithmetic in a different order: rtol 1e-5, atol 1e-4 (pixels)
    for name in ("depth", "center_px", "conic", "radius_px", "color",
                 "opacity"):
        got = getattr(tp, name).numpy()[vis]
        want = np.asarray(getattr(jp, name))[vis]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                   err_msg=name)


def test_load_ply_matches_jax(tmp_path):
    path = os.path.join(DATA, "surface_5k.ply")
    # each reader against its twin: NumPy, and the default (the C++ loader
    # where the layout allows it)
    for kw in ({"native": False}, {}, {"center": False,
                                       "f_rest_layout": "raw"}):
        want = st.load_ply(path, **kw).to_numpy()
        got = stt.load_ply(path, **kw, device="cpu").to_numpy()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    scene = stt.random_scene(64, seed=4, device="cpu")
    out = str(tmp_path / "rt.ply")
    stt.save_ply(out, scene)
    back = st.load_ply(out, center=False, native=False).to_numpy()
    for k, v in scene.to_numpy().items():
        np.testing.assert_allclose(back[k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply\n")
    with pytest.raises(stt.PlyError):
        stt.load_ply(str(bad), device="cpu")
