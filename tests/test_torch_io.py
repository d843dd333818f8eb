"""The port's scene I/O and host utilities against splat_tpu's on the same
numpy inputs (CPU): the native PLY loader, the npz cache, trim_ply,
read_png, write_gif, scene_health, frame_report, and the ellipse, sort and
overlay helpers on one projected frame.

Tolerances: equal arrays and bytes, except where stated: the native
loader's exp-activated fields (scales, opacities) against the NumPy reader
at rtol 1e-6, splat_tpu's own bound for the same pair (glibc's expf and
NumPy's vectorised exp round apart by up to 2 ulp; the sigmoid's add and
division carry that to 4);
the ellipse helpers at rtol 1e-5, as the projection."""

import shutil

import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu.io import cache as jcache
from splat_tpu.io.ply import save_ply as jax_save_ply
from splat_tpu.io.ply import trim_ply as jax_trim_ply
from splat_tpu.native.loader import load_ply_native as jax_load_ply_native
from splat_tpu.ops import ellipse as jell
from splat_tpu.ops import sort as jsort
from splat_tpu.ops.projection import project_gaussians as jax_project
from splat_tpu.utils import diagnostics as jdiag
from splat_tpu.utils import gif as jgif
from splat_tpu.utils import image as jimage
from splat_tpu.utils.overlay import draw_conics_and_bbs as jax_overlay
from splat_tpu_torch.io import cache as tcache
from splat_tpu_torch.io.ply import load_ply, trim_ply
from splat_tpu_torch.native.loader import NativeUnsupported, load_ply_native
from splat_tpu_torch.ops import ellipse as tell
from splat_tpu_torch.ops import sort as tsort
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.utils import diagnostics as tdiag
from splat_tpu_torch.utils import gif as tgif
from splat_tpu_torch.utils import image as timage
from splat_tpu_torch.utils.overlay import draw_conics_and_bbs

torch.set_num_threads(1)

FIELDS = ("means", "quats", "scales", "opacities", "sh")
H, W = 96, 128


@pytest.fixture(scope="module")
def jax_scene():
    return st.surface_scene(512, seed=11, extent=1.5)


@pytest.fixture(scope="module")
def ply(tmp_path_factory, jax_scene):
    p = tmp_path_factory.mktemp("io") / "scene.ply"
    jax_save_ply(p, jax_scene)
    return str(p)


def _arrays(scene):
    return {k: np.asarray(v) for k, v in scene.to_numpy().items()}


@pytest.mark.parametrize("center", [False, True])
def test_native_loader_matches_numpy_and_jax(ply, center):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    got = _arrays(load_ply_native(ply, center=center, device="cpu"))
    numpy_path = _arrays(load_ply(ply, center=center, native=False,
                                  device="cpu"))
    jax_native = _arrays(jax_load_ply_native(ply, center=center))
    auto = _arrays(load_ply(ply, center=center, device="cpu"))
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], jax_native[k], err_msg=k)
        np.testing.assert_array_equal(got[k], auto[k], err_msg=k)
        if k in ("scales", "opacities"):
            np.testing.assert_allclose(got[k], numpy_path[k], rtol=1e-6,
                                       atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], numpy_path[k], err_msg=k)


def test_native_loader_rules(tmp_path, monkeypatch):
    """ASCII files fall back to NumPy; "raw" f_rest and the environment
    switch keep the C++ loader off; a native build never hides a schema
    the loader cannot read."""
    from splat_tpu_torch.io import ply as tply

    p = tmp_path / "a.ply"
    p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\n"
                  b"property float x\nproperty float y\nproperty float z\n"
                  b"property float opacity\nend_header\n0 0 0 0\n")
    with pytest.raises(NativeUnsupported, match="format"):
        load_ply_native(p, device="cpu")
    assert load_ply(p, center=False, device="cpu").num_gaussians == 1
    monkeypatch.delenv("SPLAT_TPU_NO_NATIVE", raising=False)
    assert tply.native_enabled(None, "inria")
    assert not tply.native_enabled(None, "raw")
    assert not tply.native_enabled(True, "raw")
    assert not tply.native_enabled(False, "inria")
    monkeypatch.setenv("SPLAT_TPU_NO_NATIVE", "1")
    assert not tply.native_enabled(None, "inria")


def test_npz_cache_cross_loads(tmp_path, jax_scene):
    t_scene = stt.GaussianScene.from_numpy(jax_scene.to_numpy(), device="cpu")
    jcache.save_npz(tmp_path / "j.npz", jax_scene)
    tcache.save_npz(tmp_path / "t.npz", t_scene)
    from_jax = _arrays(tcache.load_npz(tmp_path / "j.npz", device="cpu"))
    from_torch = _arrays(jcache.load_npz(tmp_path / "t.npz"))
    want = _arrays(jax_scene)
    for k in FIELDS:
        np.testing.assert_array_equal(from_jax[k], want[k], err_msg=k)
        np.testing.assert_array_equal(from_torch[k], want[k], err_msg=k)


def test_load_scene_cached_reads_either_cache(tmp_path, jax_scene):
    p = tmp_path / "s.ply"
    jax_save_ply(p, jax_scene)
    want = _arrays(jcache.load_scene_cached(p))   # writes s.ply.npz
    assert (tmp_path / "s.ply.npz").exists()
    got = _arrays(tcache.load_scene_cached(p, device="cpu"))
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_trim_ply_bytes_equal(tmp_path, ply):
    assert trim_ply(ply, tmp_path / "t.ply", count=7) == 7
    assert jax_trim_ply(ply, tmp_path / "j.ply", count=7) == 7
    assert ((tmp_path / "t.ply").read_bytes()
            == (tmp_path / "j.ply").read_bytes())


def test_read_png_every_filter(tmp_path):
    """A PNG whose rows use filter types 0-4, read by both packages."""
    import struct
    import zlib

    rng = np.random.default_rng(2)
    h, w, c = 9, 7, 4
    raw = b"".join(bytes([y % 5]) + rng.integers(0, 256, w * c,
                                                 dtype=np.uint8).tobytes()
                   for y in range(h))

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    p = tmp_path / "f.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n"
                  + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0,
                                               0))
                  + chunk(b"IDAT", zlib.compress(raw))
                  + chunk(b"IEND", b""))
    got = timage.read_png(str(p))
    assert got.shape == (h, w, c) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jimage.read_png(str(p)))
    img = rng.random((5, 6, 3)).astype(np.float32)
    timage.write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(timage.read_png(str(tmp_path / "w.png")),
                                  jimage.to_uint8(img))


def test_write_gif_bytes_equal(tmp_path):
    rng = np.random.default_rng(4)
    frames = [rng.random((12, 10, 3)).astype(np.float32) for _ in range(3)]
    frames.append((rng.random((12, 10, 4)) * 255).astype(np.uint8))
    tgif.write_gif(str(tmp_path / "t.gif"),
                   [torch.from_numpy(f) for f in frames], fps=12.0)
    jgif.write_gif(str(tmp_path / "j.gif"), frames, fps=12.0)
    assert ((tmp_path / "t.gif").read_bytes()
            == (tmp_path / "j.gif").read_bytes())


def test_scene_health_equal(jax_scene):
    d = jax_scene.to_numpy()
    d["scales"][3, 1] = np.nan
    d["opacities"][5] = 1.5
    d["quats"][7] *= 2.0
    bad = st.GaussianScene.create(**d)
    for js in (jax_scene, bad):
        ts = stt.GaussianScene.from_numpy(js.to_numpy(), device="cpu")
        assert tdiag.scene_health(ts) == jdiag.scene_health(js)
    assert not tdiag.scene_health(
        stt.GaussianScene.from_numpy(bad.to_numpy(), device="cpu"))["ok"]


def _frame(jax_scene):
    jc = st.Camera.create(h=H, w=W, position=(0.2, -0.6, 3.5), yaw=0.3)
    tc = stt.Camera.create(h=H, w=W, position=(0.2, -0.6, 3.5), yaw=0.3,
                           device="cpu")
    ts = stt.GaussianScene.from_numpy(jax_scene.to_numpy(), device="cpu")
    return jc, tc, ts


def test_frame_report_counts_equal(jax_scene):
    jc, tc, ts = _frame(jax_scene)
    cfg = dict(max_dup_factor=3.0)
    got = tdiag.frame_report(ts, tc, stt.RenderConfig(**cfg))
    want = jdiag.frame_report(jax_scene, jc, st.RenderConfig(**cfg))
    assert set(got) == set(want)
    for k in ("visible", "num_pairs", "overflow"):
        assert got[k] == want[k], k
    assert got["num_pairs"] > 0 and (got["height"], got["width"]) == (H, W)


def test_ellipse_sort_overlay_on_one_frame(jax_scene):
    jc, tc, ts = _frame(jax_scene)
    cfg = dict(sh_degree=3)
    proj = project_gaussians(ts, tc, stt.RenderConfig(**cfg))
    jproj = jax_project(jax_scene, jc, st.RenderConfig(**cfg))

    np.testing.assert_array_equal(
        tsort.sort_gaussians(ts, tc).numpy(),
        np.asarray(jsort.sort_gaussians(jax_scene, jc)))
    np.testing.assert_array_equal(
        tsort.sort_gaussians_front_to_back(ts, tc).numpy(),
        np.asarray(jsort.sort_gaussians_front_to_back(jax_scene, jc)))

    view_t, view_j = tc.view_matrix(), jc.view_matrix()
    conic3 = tell.projected_covariance_of_ellipsoid(
        ts.means, ts.quats, ts.scales, view_t)
    jconic3 = jell.projected_covariance_of_ellipsoid(
        jax_scene.means, jax_scene.quats, jax_scene.scales, view_j)
    scale = float(np.nanmax(np.abs(np.asarray(jconic3))))
    np.testing.assert_allclose(conic3.numpy(), np.asarray(jconic3),
                               rtol=1e-5, atol=1e-5 * scale)
    vis = jproj.visible
    a, b, c = (jproj.conic[:, i][vis] for i in range(3))
    ta, tb, tc_ = (proj.conic[:, i][torch.tensor(np.asarray(vis))]
                   for i in range(3))
    for tf, jf in ((tell.extract_scale_of_covariance,
                    jell.extract_scale_of_covariance),
                   (tell.extract_rotation_of_ellipse,
                    jell.extract_rotation_of_ellipse)):
        for g, w_ in zip(tf(ta, tb, tc_), jf(a, b, c)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-4,
                                       atol=1e-5)
    np.testing.assert_allclose(
        tell.extract_translation_of_ellipse(conic3).numpy(),
        np.asarray(jell.extract_translation_of_ellipse(jconic3)),
        rtol=1e-4, atol=1e-4)

    got = draw_conics_and_bbs(proj, H, W, max_gaussians=16)
    want = jax_overlay(jproj, H, W, max_gaussians=16)
    assert got.shape == (H, W, 3) and got.max() > 0
    # the same outlines, bar pixels on a band edge that f32 rounding moves
    assert (np.abs(got - want).max(-1) > 0).mean() < 0.002
