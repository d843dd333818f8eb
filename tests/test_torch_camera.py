"""The port's cameras (SE(3) and the orbit camera's helpers) against
splat_tpu's, and the projection and tiled render at a rolled SE(3) pose with
fx != fy and an off-centre principal point (CPU).

Tolerances: camera matrices and vectors at atol 1e-6 (the same f32
formulas); projected fields at rtol 1e-5; the tiled image >= 50 dB against
splat_tpu.render_tiled (Pallas in interpret mode) and >= 45 dB against the
NumPy oracle."""

import math

import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu import camera as jcam
from splat_tpu.ops.projection import project_gaussians as jax_project
from splat_tpu.render.oracle import render_oracle
from splat_tpu.render.tiled import render_tiled as jax_render_tiled
from splat_tpu_torch import camera as tcam
from splat_tpu_torch.ops.projection import project_gaussians

torch.set_num_threads(1)

H, W = 96, 128
FX, FY, CX, CY = 150.0, 110.0, 70.0, 52.0
ATOL = 1e-6


def rolled_view(roll: float = 0.4) -> np.ndarray:
    """A look_at view from (0.3, -0.6, 3.6), rolled about the view axis."""
    base = np.asarray(st.Camera.create(h=H, w=W, position=(0.3, -0.6, 3.6),
                                       target=(0.05, 0.1, 0.0)).view_matrix())
    c, s = math.cos(roll), math.sin(roll)
    r = np.eye(4, dtype=np.float32)
    r[:2, :2] = [[c, -s], [s, c]]
    return (r @ base).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want):
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w_), rtol=0, atol=ATOL)


def _se3_pair(kind):
    if kind == "create":
        v = rolled_view()
        return (st.SE3Camera.create(h=H, w=W, view=v, fx=FX, fy=FY, cx=CX,
                                    cy=CY),
                stt.SE3Camera.create(h=H, w=W, view=v, fx=FX, fy=FY, cx=CX,
                                     cy=CY, device="cpu"))
    if kind == "create_defaults":
        v = rolled_view(-0.2)
        return (st.SE3Camera.create(h=H, w=W, view=v, fx=FX),
                stt.SE3Camera.create(h=H, w=W, view=v, fx=FX, device="cpu"))
    q, t = (0.9, -0.1, 0.3, 0.2), (0.1, -0.2, 3.5)
    return (st.SE3Camera.from_colmap(q, t, FX, FY, CX, CY, H, W),
            stt.SE3Camera.from_colmap(q, t, FX, FY, CX, CY, H, W,
                                      device="cpu"))


def _orbit_pair(**kw):
    kw = dict(h=H, w=W, position=(0.4, -0.8, 3.5), yaw=0.3, pitch=-0.2,
              fovy=1.2, **kw)
    return st.Camera.create(**kw), stt.Camera.create(**kw, device="cpu")


def _check_se3(kind):
    j, t = _se3_pair(kind)
    assert isinstance(t, tcam.SE3Camera) and (t.h, t.w) == (H, W)
    _close([t.view_matrix(), t.projection_matrix(), t.eye(), t.sh_eye(True),
            *t.intrinsics_px(), *t.htanfovxy_focal()],
           [j.view_matrix(), j.projection_matrix(), j.eye(), j.sh_eye(True),
            *j.intrinsics_px(), *j.htanfovxy_focal()])
    js, ts = j.scaled(2), t.scaled(2)
    assert (ts.h, ts.w) == (js.h, js.w) == (2 * H, 2 * W)
    _close([*ts.intrinsics_px(), ts.projection_matrix()],
           [*js.intrinsics_px(), js.projection_matrix()])


def _check_to_se3():
    j, t = _orbit_pair()
    js, ts = j.to_se3(), t.to_se3()
    _close([ts.view_matrix(), *ts.intrinsics_px(), ts.projection_matrix(),
            ts.eye()],
           [js.view_matrix(), *js.intrinsics_px(), js.projection_matrix(),
            js.eye()])


def _check_with_pose():
    j, t = _orbit_pair()
    pos = np.asarray([0.2, -1.1, 2.9], np.float32)
    jw = j.with_pose(yaw=0.7, pitch=0.1, position=pos)
    tw = t.with_pose(yaw=0.7, pitch=0.1, position=pos)
    assert tw.yaw.dtype == torch.float32 and tw.position.device == t.device
    _close([tw.view_matrix(), tw.eye()], [jw.view_matrix(), jw.eye()])


def _check_reset():
    j, t = _orbit_pair()
    jr, tr = j.rotate(0.5, 0.2).reset(), t.rotate(0.5, 0.2).reset()
    assert float(tr.yaw) == float(tr.pitch) == 0.0
    _close([tr.view_matrix()], [jr.view_matrix()])


def _check_stack():
    j1, t1 = _se3_pair("create")
    j2, t2 = _se3_pair("colmap")
    stacked = tcam.stack_cameras([t1, t2])
    assert stacked == [t1, t2]
    jst = jcam.stack_cameras([j1, j2])
    _close([stacked[1].view_matrix()], [jst.view[1]])
    jbad = st.SE3Camera.create(h=H + 8, w=W, view=rolled_view(), fx=FX)
    tbad = stt.SE3Camera.create(h=H + 8, w=W, view=rolled_view(), fx=FX,
                                device="cpu")
    for mod, cams in ((jcam, [j1, jbad]), (tcam, [t1, tbad]),
                      (jcam, []), (tcam, [])):
        with pytest.raises(ValueError):
            mod.stack_cameras(cams)


def _check_point_maps():
    rng = np.random.default_rng(3)
    pts = rng.normal(0.0, 0.8, (64, 3)).astype(np.float32)
    for j, t in (_se3_pair("create"), _orbit_pair()):
        jc = jcam.world_to_cam(j, pts)
        tc = tcam.world_to_cam(t, pts)
        jn = jcam.cam_to_ndc(j, jc)
        tn = tcam.cam_to_ndc(t, tc)
        _close([tc, tn[:, :2]], [jc, jn[:, :2]])
        np.testing.assert_allclose(
            _np(tcam.ndc_to_pixel(tn[:, :2], W, H)),
            np.asarray(jcam.ndc_to_pixel(jn[:, :2], W, H)), rtol=1e-5,
            atol=1e-4)


_CASES = {
    "se3_create": lambda: _check_se3("create"),
    "se3_create_defaults": lambda: _check_se3("create_defaults"),
    "se3_from_colmap": lambda: _check_se3("colmap"),
    "orbit_to_se3": _check_to_se3,
    "orbit_with_pose": _check_with_pose,
    "orbit_reset": _check_reset,
    "stack_cameras": _check_stack,
    "world_cam_ndc_pixel": _check_point_maps,
}


@pytest.mark.parametrize("case", list(_CASES))
def test_camera_matches_jax(case):
    _CASES[case]()


def test_se3_pixels_follow_intrinsics():
    """With fx != fy and a centred principal point, the projection matrix
    puts a camera-space point on the pixel the intrinsics give
    (x = cx + fx x / -z, y = cy - fy y / -z); an off-centre principal
    point lands mirrored, at (w - cx, h - cy), as in splat_tpu."""
    p = torch.tensor([[0.3, -0.2, -2.5], [-0.6, 0.4, -4.0]])
    for cx, cy, at_x, at_y in ((W / 2, H / 2, W / 2, H / 2),
                               (CX, CY, W - CX, H - CY)):
        t = stt.SE3Camera.create(h=H, w=W, view=rolled_view(), fx=FX, fy=FY,
                                 cx=cx, cy=cy, device="cpu")
        px = tcam.ndc_to_pixel(tcam.cam_to_ndc(t, p)[:, :2], W, H)
        want = torch.stack([at_x + FX * p[:, 0] / -p[:, 2],
                            at_y - FY * p[:, 1] / -p[:, 2]], dim=-1)
        torch.testing.assert_close(px, want, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def scene_pair():
    js = st.surface_scene(512, seed=5, extent=1.5)
    return js, stt.GaussianScene.from_numpy(js.to_numpy(), device="cpu")


def test_project_at_rolled_se3_pose(scene_pair):
    js, ts = scene_pair
    jc, tc = _se3_pair("create")
    cfg = dict(sh_degree=3)
    got = project_gaussians(ts, tc, stt.RenderConfig(**cfg))
    want = jax_project(js, jc, st.RenderConfig(**cfg))
    vis = np.asarray(want.visible)
    assert vis.sum() > 100
    np.testing.assert_array_equal(_np(got.visible), vis)
    for name in ("depth", "center_px", "conic", "radius_px", "color",
                 "opacity"):
        np.testing.assert_allclose(_np(getattr(got, name))[vis],
                                   np.asarray(getattr(want, name))[vis],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", ["create", "colmap"])
def test_render_tiled_at_se3_pose(scene_pair, kind):
    js, ts = scene_pair
    jc, tc = _se3_pair(kind)
    got = stt.render_tiled(ts, tc, stt.RenderConfig(chunk=64)).numpy()
    jcfg = st.RenderConfig(chunk=64)
    want = np.asarray(jax_render_tiled(js, jc, jcfg, interpret=True))
    gold = render_oracle(js, jc, jcfg)
    assert got.shape == (H, W, 3) and got.mean() > 0.01
    assert stt.psnr(got, want) >= 50.0
    assert stt.psnr(got, gold) >= 45.0
