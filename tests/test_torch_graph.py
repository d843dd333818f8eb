"""The compiled frame (``splat_tpu_torch/render/graph.py``, the port's
``jax.jit``) on the CPU: ``render_fn`` held against ``splat_tpu``'s jitted
``render_fn`` (Pallas in interpret mode), the cache's key and eviction
rules as plain functions, and the CPU path, which captures nothing.  The
captures themselves need the card: ``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu_torch.render import graph
from splat_tpu_torch.render.api import frame_fn
from splat_tpu_torch.scene import DeviceScene
from splat_tpu_torch.utils import benchmark
from splat_tpu_torch.viewer.server import make_server

torch.set_num_threads(1)

H, W = 64, 96
CAM = dict(h=H, w=W, position=(0.0, -0.5, 4.0), yaw=0.4)
CFG = dict(chunk=64)


def _numpy_scene(n=1500, seed=5):
    return st.random_scene(n, seed=seed, extent=2.0,
                           scale_range=(0.01, 0.1)).to_numpy()


def _tscene(d):
    return stt.GaussianScene.from_numpy(d, device="cpu")


def _tcam():
    return stt.Camera.create(**CAM, device="cpu")


@pytest.fixture(scope="module")
def ref():
    """The numpy scene and splat_tpu's jitted render_fn of it, tiled (on
    the packed scene, as its frame loops take it) and dense: the module's
    one JAX reference (~4 s)."""
    d = _numpy_scene()
    js = st.GaussianScene(**d)
    jc = st.Camera.create(**CAM)
    jcfg = st.RenderConfig(**CFG)
    return d, {"tiled": np.asarray(st.render_fn("tiled", jcfg)(
                   js.pack_device(), jc)),
               "dense": np.asarray(st.render_fn("dense", jcfg)(js, jc))}


@pytest.mark.parametrize("method", ["tiled", "dense"])
def test_render_fn_matches_splat_tpu(ref, method):
    """Within 2e-5 of splat_tpu's render_fn (the two packages' exp and
    division round apart)."""
    d, want = ref
    scene = _tscene(d)
    if method == "tiled":
        scene = scene.pack_device()
    got = stt.render_fn(method, stt.RenderConfig(**CFG))(scene, _tcam())
    assert got.shape == want[method].shape == (H, W, 3)
    assert got.mean() > 0.01                       # something was drawn
    np.testing.assert_allclose(got.numpy(), want[method], atol=2e-5,
                               rtol=0)


def _key(scene, cam, method="tiled", cfg=None, stats=False):
    return graph.frame_key((method, cfg or stt.RenderConfig(**CFG), stats),
                           scene, cam)


def test_frame_key_holds_what_a_capture_bakes_in():
    scene = _tscene(_numpy_scene(300, seed=3)).pack_device()
    cam = _tcam()
    base = _key(scene, cam)
    changed = {
        "config": _key(scene, cam, cfg=stt.RenderConfig(chunk=32)),
        "method": _key(scene, cam, method="dense"),
        "stats": _key(scene, cam, stats=True),
        "height": _key(scene, dataclasses.replace(cam, h=H // 2)),
        "width": _key(scene, dataclasses.replace(cam, w=W // 2)),
        # the same memory, fewer gaussians
        "n": _key(DeviceScene.from_buffer(scene.buffer[:, :299]), cam),
        "device": _key(DeviceScene.from_buffer(scene.buffer.to("meta")),
                       cam),
        "buffer": _key(DeviceScene.from_buffer(scene.buffer.clone()), cam),
        "camera_kind": _key(scene, cam.to_se3()),
        "unpacked": _key(_tscene(_numpy_scene(300, seed=3)), cam),
    }
    for what, key in changed.items():
        assert key != base, what
    # a new pose, another scene object over the same buffer and an
    # in-place edit of the buffer all replay the same graph
    assert _key(scene, cam.rotate(0.7, 0.2)) == base
    assert _key(DeviceScene.from_buffer(scene.buffer), cam) == base
    scene.buffer[0].add_(0.25)
    assert _key(scene, cam) == base


def test_a_changing_scene_keeps_its_frame_key():
    """render() packs a GaussianScene (``pack_device``): an edit in place,
    and a scene of inference tensors, which re-packs every call, refill
    the same pack, so the key stays and on the card one graph serves."""
    scene = _tscene(_numpy_scene(300, seed=3))
    cam = _tcam()
    base = _key(scene.pack_device(), cam)
    scene.means.add_(0.1)
    assert _key(scene.pack_device(), cam) == base
    with torch.inference_mode():
        inf = _tscene(_numpy_scene(300, seed=3))
        first = _key(inf.pack_device(), cam)
        inf.opacities.mul_(0.5)
    assert _key(inf.pack_device(), cam) == first
    # the refilled pack renders as a fresh one (an explicit device packs
    # afresh)
    cfg = stt.RenderConfig(**CFG)
    assert torch.equal(stt.render(inf, cam, cfg, method="tiled"),
                       stt.render_tiled(inf.pack_device("cpu"), cam, cfg))


def test_every_kernel_wrapper_registers_its_counters():
    """A replay adds the launches its capture counted to the counters
    that the kernel wrappers registered: the projection front end and
    K1-K4, each with its launch count, K2 and K3 with the tensors of their
    last launch."""
    from splat_tpu_torch.render.diff import (rasterize_train_bwd,
                                             rasterize_train_fwd)
    from splat_tpu_torch.render.expand import expand_pair_keys
    from splat_tpu_torch.render.front import project_front
    from splat_tpu_torch.render.kernels import rasterize_tiles
    got = {fn: (attrs, last) for fn, attrs, last in graph._COUNTED}
    assert got == {
        project_front: (("launches", "count_launches"), ()),
        expand_pair_keys: (("launches", "cull_launches"), ()),
        rasterize_tiles: (("launches", "subtile_launches"),
                          ("split_tiles", "tile_order")),
        rasterize_train_fwd: (("launches",), ("split_tiles",)),
        rasterize_train_bwd: (("launches",), ())}
    for fn, (attrs, last) in got.items():
        assert all(isinstance(getattr(fn, a), int) for a in attrs)
        assert all(hasattr(fn, a) for a in last)


def test_frame_cache_evicts_the_least_recently_used():
    cache = graph.FrameCache(2)
    made = []

    def make(k):
        return lambda: made.append(k) or k.upper()

    assert cache.get("a", make("a")) == "A"
    assert cache.get("b", make("b")) == "B"
    assert cache.get("a", make("a")) == "A"      # a hit: "a" is now newest
    assert cache.get("c", make("c")) == "C"      # evicts "b"
    assert made == ["a", "b", "c"]
    assert len(cache) == 2 and "a" in cache and "c" in cache
    assert "b" not in cache
    assert cache.get("b", make("b")) == "B"      # made again; evicts "a"
    assert made == ["a", "b", "c", "b"] and "a" not in cache


def test_cpu_frames_capture_nothing():
    scene = _tscene(_numpy_scene(800, seed=2)).pack_device()
    cam = _tcam()
    cfg = stt.RenderConfig(**CFG)
    before, cached = dict(graph.counts), len(graph._CACHE)
    want = stt.render_tiled(scene, cam, cfg)
    assert torch.equal(stt.render_fn("tiled", cfg)(scene, cam), want)
    assert torch.equal(stt.render(scene, cam, cfg, method="tiled"), want)
    img, stats = frame_fn("tiled", cfg, return_stats=True)(scene, cam)
    assert torch.equal(img, want) and int(stats["overflow"]) == 0
    srv = make_server(scene, cam, cfg, port=0, method="tiled")
    try:
        frame, overflow = srv.render_pose(0.4, 0.0, 1.0, "color", 1.0)
    finally:
        srv.server_close()
    u8 = (torch.clamp(want, 0, 1) * 255 + 0.5).to(torch.uint8).numpy()
    np.testing.assert_array_equal(frame, u8)
    assert overflow == 0
    assert graph.counts == before and len(graph._CACHE) == cached
    with pytest.raises(ValueError, match="CUDA"):
        graph.capture(lambda s, c: None, scene, cam)


def test_chained_sweep_programs_equal_frame_by_frame_renders():
    """chained_bench's two programs (the dependent sweep and its audit),
    run as they are on the CPU, against one render_tiled a pose."""
    scene = _tscene(_numpy_scene(800, seed=2)).pack_device()
    cam = _tcam()
    cfg = stt.RenderConfig(**CFG)
    sweep, audit = benchmark._sweep_fns(cfg, 3)
    means, worst = sweep(scene, cam), audit(scene, cam)
    stats = []
    for i in range(3):
        yaw = cam.yaw + torch.tensor(0.01, dtype=torch.float32) * i
        img, st_i = stt.render_tiled(scene, dataclasses.replace(cam, yaw=yaw),
                                     cfg, return_stats=True)
        assert float(means[i]) == float(img.mean()), i
        stats.append([int(st_i[k]) for k in ("overflow", "num_pairs",
                                             "visible")])
    assert worst.tolist() == np.max(stats, axis=0).tolist()
