"""The projection front end's kernel (``csrc/project.cu``) on the card.

Against its plain version (``render/front.py::project_front_plain``, the
same PyTorch ops on the card), bit for bit on every output, at the 1M
random and 1M surface frames at 1080p and on a cloud of odd splats, with
every flag the projection and the slot layout read and both camera kinds;
two poses replayed through one captured frame; the launches of the frame,
of ``fit``'s demand pass and of training's projection (none).

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_front.py
"""

import dataclasses

import pytest
import torch

import splat_tpu_torch as stt
from splat_tpu_torch import train
from splat_tpu_torch.render import graph
from splat_tpu_torch.render.api import frame_fn
from splat_tpu_torch.render.diff import rasterize_train_fwd
from splat_tpu_torch.render.front import project_front, project_front_plain
from test_torch_front import FLAGS, camera, odd_scene

pytestmark = pytest.mark.cuda

H, W = 1080, 1920


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scenes(dev):
    """The benchmark's two 1M frames (bench.py's scenes) and the odd
    cloud, packed on the card."""
    return {
        "random": stt.random_scene(1_000_000, seed=0, extent=3.0,
                                   scale_range=(0.004, 0.03),
                                   device=dev).pack_device(),
        "surface": stt.surface_scene(1_000_000, seed=0,
                                     device=dev).pack_device(),
        "odd": odd_scene(20_000, seed=5, device=dev).pack_device(),
    }


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _mismatch(got, want) -> str:
    """'' where equal bit for bit, else how many elements differ and by
    how far (ulp of the f32 bits, where the signs agree)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"{got.dtype} {tuple(got.shape)} vs {want.dtype} " \
               f"{tuple(want.shape)}"
    g, w = _bits(got), _bits(want)
    bad = g != w
    if not bad.any():
        return ""
    ulp = (g[bad].to(torch.int64) - w[bad].to(torch.int64)).abs().max()
    return f"{int(bad.sum())} differ, max {int(ulp)} ulp/units"


def _compare(front, plain) -> dict:
    out = {}
    for f in dataclasses.fields(front):
        g, w = getattr(front, f.name), getattr(plain, f.name)
        if g is None or w is None:
            if (g is None) != (w is None):
                out[f.name] = "missing"
            continue
        if f.name == "features":
            for r in range(g.shape[0]):
                out[f"features[{r}]"] = _mismatch(g[r], w[r])
        else:
            out[f.name] = _mismatch(g, w)
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("kind", ["orbit", "se3"])
@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
@pytest.mark.parametrize("frame", ["random", "surface", "odd"])
def test_front_kernel_equals_plain(dev, scenes, frame, flags, kind):
    scene = scenes[frame]
    cfg = stt.RenderConfig(**FLAGS[flags])
    cam = camera(kind, H, W, dev)
    before = (project_front.launches, project_front.count_launches)
    got = project_front(scene, cam, cfg)
    want = project_front_plain(scene, cam, cfg)
    torch.cuda.synchronize()
    assert _compare(got, want) == {}
    assert int(got.num_visible) > 0
    counts = project_front(scene, cam, cfg, count_only=True)
    assert (project_front.launches, project_front.count_launches) == (
        before[0] + 2, before[1] + 1)
    plain = project_front_plain(scene, cam, cfg, count_only=True)
    assert counts.tolist() == plain.tolist() == [
        int(want.num_visible), int(want.counts.sum())]


def test_front_kernel_reads_a_column_slice_and_an_unpacked_scene(dev):
    scene = odd_scene(20_000, seed=6, device=dev)
    buf = scene.pack_device().buffer
    cfg = stt.RenderConfig(cull_pairs=True)
    cam = camera("orbit", H, W, dev)
    shard = stt.DeviceScene.from_buffer(buf[:, 5000:15000])
    assert _compare(project_front(shard, cam, cfg),
                    project_front_plain(shard, cam, cfg)) == {}
    assert _compare(project_front(scene, cam, cfg),
                    project_front_plain(scene, cam, cfg)) == {}


def test_two_poses_replay_through_one_capture(dev, scenes):
    scene = scenes["random"]
    cfg = stt.RenderConfig()
    cams = [stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), yaw=y,
                              pitch=p, device=dev)
            for y, p in ((0.1, 0.0), (1.3, 0.2))]
    f = frame_fn("tiled", cfg, return_stats=True)
    graph.clear()
    caps, launches = graph.counts["captures"], project_front.launches
    outs = [f(scene, c) for c in cams]            # a capture, two replays
    assert graph.counts["captures"] == caps + 1
    # the capture's eager warm-up launches once more
    assert project_front.launches == launches + 3
    for c, (img, stats) in zip(cams, outs):
        want, wstats = stt.render_tiled(scene, c, cfg, return_stats=True)
        assert torch.equal(img, want)
        for k in wstats:
            assert torch.equal(stats[k], wstats[k]), k
    assert not torch.equal(outs[0][0], outs[1][0])
    n = project_front.launches
    f(scene, cams[0])
    assert project_front.launches == n + 1
    graph.clear()


def test_demand_pass_launches_once_a_view(dev, scenes):
    scene = scenes["surface"]
    cfg = stt.RenderConfig()
    cams = [stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), yaw=y,
                              device=dev) for y in (0.0, 0.7, 2.1)]
    before = (project_front.launches, project_front.count_launches)
    got = train._view_pairs(scene, cams, cfg)
    assert (project_front.launches, project_front.count_launches) == (
        before[0] + 3, before[1] + 3)
    want = [int(project_front_plain(scene, c, cfg, count_only=True)[1])
            for c in cams]
    assert got.tolist() == want


def test_training_projection_launches_no_front_kernel(dev):
    scene = odd_scene(20_000, seed=7, device=dev)
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in ("means", "quats", "scales", "opacities", "sh")}
    cam = stt.Camera.create(h=200, w=300, position=(0.0, 0.0, 4.0),
                            device=dev)
    before, fwd = project_front.launches, rasterize_train_fwd.launches
    img = stt.render_tiled_diff(stt.GaussianScene(**leaves), cam)
    img.sum().backward()
    torch.cuda.synchronize()
    assert rasterize_train_fwd.launches == fwd + 1
    assert project_front.launches == before
    g = leaves["means"].grad[140:]
    assert torch.isfinite(g).all() and g.abs().sum() > 0
