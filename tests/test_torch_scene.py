"""The port's feature-major scene (``DeviceScene``,
``GaussianScene.pack_device``) against splat_tpu's, and every inference
entry point on it against the same scene unpacked (CPU).

The packed layout changes where the projection reads its columns, not
what it computes, so packed and unpacked renders are held equal bit for
bit; the packed render is held against splat_tpu's packed render_tiled
(Pallas in interpret mode) and the NumPy oracle."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu.render.oracle import render_oracle
from splat_tpu.render.tiled import render_tiled as jax_render_tiled
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.parallel import sharding
from splat_tpu_torch.render import api
from splat_tpu_torch.scene import PACKED_ROWS, DeviceScene

torch.set_num_threads(1)

H, W = 64, 96
N = 2000
CAM = dict(h=H, w=W, position=(0.0, -0.5, 4.0), yaw=0.3)
FIELDS = ("mx", "my", "mz", "qw", "qx", "qy", "qz", "sx", "sy", "sz",
          "opacities")

# the configurations packed and unpacked renders are held equal under:
# depth mode with its per-frame range and rectangular tiles are two that
# no other port test pins
_CONFIGS = {
    "default": {},
    "depth_auto_range": dict(render_mode="depth"),
    "rgba_background": dict(alpha_channel=True, background=(0.1, 0.3, 0.6)),
    "sh_degree_2": dict(sh_degree=2),
    "tiles_32x16": dict(tile_px=32, tile_py=16),
}


def _numpy_scene(n=N, seed=8):
    return st.random_scene(n, seed=seed, extent=2.0,
                           scale_range=(0.01, 0.1)).to_numpy()


def _tscene(d):
    return stt.GaussianScene.from_numpy(d, device="cpu")


def _tcam():
    return stt.Camera.create(**CAM, device="cpu")


@pytest.fixture(scope="module")
def ref():
    """The numpy scene and splat_tpu's packed render of it (the one JAX
    reference of this module), with the oracle's image."""
    d = _numpy_scene()
    js = st.GaussianScene(**d)
    jc = st.Camera.create(**CAM)
    jcfg = st.RenderConfig(chunk=64)
    img = np.asarray(jax_render_tiled(js.pack_device(), jc, jcfg,
                                      interpret=True))
    return d, img, render_oracle(js, jc, jcfg)


# render_tiled's knobs pinned against splat_tpu's render_tiled: depth mode
# with its per-frame range and with an explicit one, rectangular tiles
_KNOBS = {
    "depth_auto_range": dict(render_mode="depth"),
    "depth_explicit_range": dict(render_mode="depth", depth_range=(2.5, 5.5)),
    "tiles_32x16": dict(tile_px=32, tile_py=16),
    "tiles_16x32": dict(tile_px=16, tile_py=32),
}


@pytest.fixture(scope="module")
def knob_refs():
    """splat_tpu's render_tiled of the module's scene under each knob
    (Pallas in interpret mode, jitted: ~2 s each)."""
    d = _numpy_scene()
    js = st.GaussianScene(**d).pack_device()
    jc = st.Camera.create(**CAM)
    return d, {name: np.asarray(jax.jit(
        lambda s, c, kw=kw: jax_render_tiled(
            s, c, st.RenderConfig(chunk=64, **kw), interpret=True))(js, jc))
        for name, kw in _KNOBS.items()}


@pytest.mark.parametrize("knob", list(_KNOBS))
def test_render_tiled_knobs_match_splat_tpu(knob_refs, knob):
    """Within 2e-5 of splat_tpu's image (the two packages' exp and
    division round apart: 121-123 dB here)."""
    d, want = knob_refs
    got = stt.render_tiled(_tscene(d), _tcam(),
                           stt.RenderConfig(chunk=64, **_KNOBS[knob]))
    assert got.shape == want[knob].shape
    np.testing.assert_allclose(got.numpy(), want[knob], atol=2e-5, rtol=0)


def test_pack_device_equals_splat_tpu():
    d = _numpy_scene(300, seed=3)
    want = st.GaussianScene(**d).pack_device()
    got = _tscene(d).pack_device()
    assert isinstance(got, stt.DeviceScene)
    assert got.num_gaussians == len(got) == 300
    assert got.device == torch.device("cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert len(got.sh) == len(want.sh) == 48
    for i, (g, w) in enumerate(zip(got.sh, want.sh)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"sh[{i}]")
    # one contiguous (59, N) buffer, every field a dense row view of it
    buf = got.buffer
    assert buf.shape == (PACKED_ROWS, 300) and buf.is_contiguous()
    rows = [getattr(got, k) for k in FIELDS] + list(got.sh)
    for i, r in enumerate(rows):
        assert r.is_contiguous()
        assert r.data_ptr() == buf[i].data_ptr()


@pytest.mark.parametrize("case", list(_CONFIGS))
def test_render_tiled_packed_equals_unpacked(case):
    ts = _tscene(_numpy_scene())
    cfg = stt.RenderConfig(chunk=64, **_CONFIGS[case])
    a = stt.render_tiled(ts, _tcam(), cfg)
    b = stt.render_tiled(ts.pack_device(), _tcam(), cfg)
    assert a[..., :3].mean() > 0.01          # something was drawn
    assert torch.equal(a, b)


def test_projection_packed_equals_unpacked():
    ts = _tscene(_numpy_scene(500, seed=5))
    cam = _tcam()
    for cfg in (stt.RenderConfig(), stt.RenderConfig(cov3d_transpose=True,
                                                     tight_radius=False)):
        a = project_gaussians(ts, cam, cfg)
        b = project_gaussians(ts.pack_device(), cam, cfg)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                f.name


def test_packed_render_matches_splat_tpu_and_oracle(ref):
    d, want, gold = ref
    got = stt.render_tiled(_tscene(d).pack_device(), _tcam(),
                           stt.RenderConfig(chunk=64)).numpy()
    assert got.shape == want.shape == (H, W, 3)
    assert stt.psnr(got, want) >= 50.0
    assert stt.psnr(got, gold) >= 45.0


def test_render_packs_once_per_scene(ref, monkeypatch):
    packs = []
    real = DeviceScene.from_buffer.__func__

    def counted(cls, buf):
        packs.append(buf.shape)
        return real(cls, buf)

    monkeypatch.setattr(DeviceScene, "from_buffer", classmethod(counted))
    api._AUTO_CONFIG_CACHE.clear()
    ts = _tscene(ref[0])
    cams = [_tcam().rotate(0.1 * i) for i in range(3)]
    imgs = [stt.render(ts, c, method="tiled") for c in cams]
    assert len(packs) == 1
    (key, (ref_w, cfg)), = api._AUTO_CONFIG_CACHE.items()
    packed = ts.pack_device()
    assert len(packs) == 1 and ref_w() is packed and key[0] == id(packed)
    for c, img in zip(cams, imgs):
        assert torch.equal(img, stt.render_tiled(packed, c, cfg))
    # an edit in place re-packs, and the next frame sees the edit
    with torch.no_grad():
        ts.opacities.mul_(0.5)
    dim = stt.render(ts, cams[0], method="tiled")
    assert len(packs) == 2
    assert torch.equal(dim, stt.render_tiled(ts, cams[0], cfg))
    assert float(dim.mean()) < float(imgs[0].mean())


def test_pack_memo():
    ts = stt.random_scene(32, seed=1, device="cpu")
    p1 = ts.pack_device()
    assert ts.pack_device() is p1
    assert ts.pad_to(64).pack_device() is not p1
    assert ts.pad_to(64).pack_device().num_gaussians == 64
    # an explicit device is a fresh pack, never the memo
    assert ts.pack_device("cpu") is not p1
    # a leaf edited in place, directly or through a view, re-packs
    ts.means.add_(1.0)
    p2 = ts.pack_device()
    assert p2 is not p1 and torch.equal(p2.mx, ts.means[:, 0])
    ts.sh[:, 3, 1].fill_(0.25)
    p3 = ts.pack_device()
    assert p3 is not p2 and bool((p3.sh[3 * 3 + 1] == 0.25).all())
    # a pack made inside inference_mode is an ordinary tensor, and the
    # memo stays usable outside it
    fresh = stt.random_scene(16, seed=2, device="cpu")
    with torch.inference_mode():
        inner = fresh.pack_device()
    assert not inner.buffer.is_inference()
    assert fresh.pack_device() is inner


def test_render_dense_packed_equals_unpacked():
    ts = _tscene(_numpy_scene(300, seed=6))
    for cfg in (stt.RenderConfig(), stt.RenderConfig(alpha_channel=True,
                                                     supersample=2)):
        a = stt.render_dense(ts, _tcam(), cfg)
        b = stt.render_dense(ts.pack_device(), _tcam(), cfg)
        assert a.max() > 0.1 and torch.equal(a, b)
    # render() takes a packed scene on either path
    assert torch.equal(stt.render(ts.pack_device(), _tcam(), method="dense"),
                       stt.render_dense(ts, _tcam()))


def test_empty_scene_packs_and_renders_background():
    empty = stt.random_scene(0, seed=0, device="cpu").pack_device()
    assert empty.num_gaussians == 0 and empty.buffer.shape == (PACKED_ROWS, 0)
    cam = stt.Camera.create(h=16, w=24, device="cpu")
    cfg = stt.RenderConfig(alpha_channel=True, background=(0.2, 0.5, 0.7))
    want = np.broadcast_to(np.float32([0.2, 0.5, 0.7, 0.0]), (16, 24, 4))
    for img in (stt.render_tiled(empty, cam, cfg),
                stt.render_dense(empty, cam, cfg),
                stt.render(empty, cam, cfg, method="tiled")):
        np.testing.assert_array_equal(img.numpy(), want)


@pytest.mark.parametrize("order", ["random", "y_sorted"])
def test_sharding_helpers_take_a_packed_scene(order):
    d = _numpy_scene(1024, seed=9)
    if order == "y_sorted":
        d = {k: v[np.argsort(d["means"][:, 1], kind="stable")]
             for k, v in d.items()}
    ts = _tscene(d)
    packed = ts.pack_device()
    assert (sharding.shard_spatial_score(packed, 4)
            == sharding.shard_spatial_score(ts, 4))
    assert sharding._auto_cap_factor(packed, 4) == \
        sharding._auto_cap_factor(ts, 4)
    got, got_p = sharding.prepare_scene_for_sharding(packed, 4, seed=3)
    want, want_p = sharding.prepare_scene_for_sharding(ts, 4, seed=3)
    assert got_p == want_p == (order == "y_sorted")
    assert isinstance(got, DeviceScene)
    assert torch.equal(got.buffer, want.pack_device().buffer)
