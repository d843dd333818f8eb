"""The port's multi-device rendering and training (splat_tpu_torch.parallel,
fit(mesh=)) on a CPU world of 4 gloo ranks, held against the single-device
port and splat_tpu.

One world of 4 rank processes (tests/torch_parallel_ranks.py: torch only,
one thread each, a file store under tmp_path) runs every case on meshes
(1, 4), (4, 1) and (2, 2) and writes its results to .npz files, while this
process computes the references: splat_tpu's a2a routing under shard_map
and its dense renders, and the single-device port's renders, gradients and
fits.  A second spawn runs the dryrun entry point at world 2."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu.camera import orbit_trajectory as jax_orbit
from splat_tpu.ops.projection import project_gaussians as jax_project
from splat_tpu_torch.ops.projection import project_gaussians as port_project
from splat_tpu_torch.parallel import dryrun, sharding

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_ranks.py")
FIELDS = ("means", "quats", "scales", "opacities", "sh")
WORLD = 4
H = 64                       # renders, routing and TP gradients
FIT_HW = 32
ROUTE_CAP_FACTOR = 0.1       # 128 slots of 512 records a rank: overflows
MESHES = ("1x4", "2x2")


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-20))


def _close_to_port(got, want):
    """The limits of test_sharding.py for a slab-split render against one
    device: >= 55 dB, under 0.2% of pixels off by more than 1e-6."""
    assert _psnr(got, want) >= 55.0
    assert (np.abs(got - want) > 1e-6).mean() < 0.002


def _scene_inputs(prefix, scene, inputs):
    for k, v in scene.to_numpy().items():
        inputs[f"{prefix}_{k}"] = v


def _inputs():
    """Everything the ranks read: seeded splat_tpu scenes, the camera
    specs (h, w, views, yaw sweep, SE(3)), the fields splat_tpu projected
    for the routing case and the fit targets."""
    inp = {}
    _scene_inputs("r", st.random_scene(512, seed=11, extent=2.0,
                                       scale_range=(0.02, 0.1)), inp)
    inp["r_cams"] = np.array([H, H, 4, 0.6, 0])
    inp["r_se3_cams"] = np.array([H, H, 4, 0.6, 1])
    route_scene = st.random_scene(2048, seed=23, extent=2.0,
                                  scale_range=(0.02, 0.08))
    _scene_inputs("p", route_scene, inp)
    inp["p_cams"] = np.array([H, H, 1, 0.0, 0])
    proj = jax.jit(lambda s, c: jax_project(s, c, st.RenderConfig()))(
        jax.tree.map(jnp.asarray, route_scene),
        st.Camera.create(h=H, w=H, position=(0.0, 0.0, 4.0)))
    for k in ("depth", "center_px", "conic", "radius_px", "color",
              "opacity", "visible"):
        inp[f"p_{k}"] = np.asarray(getattr(proj, k))
    inp["p_h"] = np.array(H)
    inp["p_cap_factor"] = np.array(ROUTE_CAP_FACTOR)
    _scene_inputs("g", st.random_scene(256, seed=13, extent=1.5,
                                       scale_range=(0.05, 0.15)), inp)
    inp["g_cams"] = np.array([H, H, 1, 0.0, 0])
    truth = st.random_scene(250, seed=3, extent=1.5,
                            scale_range=(0.03, 0.15)).to_numpy()
    rng = np.random.default_rng(7)
    start = dict(truth, sh=truth["sh"] * np.float32(0.6),
                 means=truth["means"] + rng.normal(
                     0, 0.03, truth["means"].shape).astype(np.float32))
    for k, v in start.items():
        inp[f"f_{k}"] = v
    inp["f_cams"] = np.array([FIT_HW, FIT_HW, 4, 0.6, 0])
    inp["f_se3_cams"] = np.array([FIT_HW, FIT_HW, 4, 0.6, 1])
    inp["f_padded_n"] = np.array(252)
    tcams = stt.orbit_trajectory(stt.Camera.create(
        h=FIT_HW, w=FIT_HW, position=(0.0, 0.0, 4.0), device="cpu"), 4,
        yaw_sweep=0.6)
    truth_t = stt.GaussianScene.from_numpy(truth, device="cpu")
    inp["f_targets"] = torch.stack([
        stt.render_dense(truth_t, c, stt.RenderConfig(sh_degree=1))
        for c in tcams]).numpy()
    return inp, proj


def _port_gate_radius(radius_px, visible):
    """The half-height a record's slab gate reads: the port routes with
    the ceil-quantized radius, splat_tpu with the radius itself, so
    splat_tpu given these radii routes as the port (its box's top edge
    must pass a slab's first row where the port's may end on it, which
    no record here does)."""
    return sharding._slab_reach(torch.tensor(np.asarray(radius_px)),
                                torch.tensor(np.asarray(visible))).numpy()


def _jax_routing(proj):
    """splat_tpu's _route_records_by_slab under shard_map on 4 devices,
    given the port's gate radii (_port_gate_radius) in place of the
    y-radius: per rank, the received rows (the port's order), visibility,
    overflow."""
    import dataclasses
    from jax.sharding import Mesh, PartitionSpec as P
    from splat_tpu.parallel.sharding import _route_records_by_slab

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(1, WORLD),
                ("d", "g"))
    radius = np.asarray(proj.radius_px).copy()
    radius[:, 1] = _port_gate_radius(radius, proj.visible)
    proj = dataclasses.replace(proj, radius_px=jnp.asarray(radius))

    def fn(p):
        rec, ov = _route_records_by_slab(p, WORLD, H // WORLD,
                                         ROUTE_CAP_FACTOR)
        return rec, ov[None]

    spec = jax.tree.map(lambda _: P("g"), proj)
    rec, ov = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,), out_specs=(spec, P("g")),
        check_vma=False))(proj)
    rows = np.concatenate([np.asarray(rec.center_px), np.asarray(rec.conic),
                           np.asarray(rec.radius_px), np.asarray(rec.color),
                           np.asarray(rec.opacity)[:, None],
                           np.asarray(rec.depth)[:, None]], axis=1)
    return (np.split(rows, WORLD), np.split(np.asarray(rec.visible), WORLD),
            np.asarray(ov))


def _tscene(inp, prefix):
    return stt.GaussianScene.from_numpy(
        {k: inp[f"{prefix}_{k}"] for k in FIELDS}, device="cpu")


def _references(inp, proj):
    """JAX and single-device port references for every case."""
    ref = {"routing": _jax_routing(proj)}
    jscene = jax.tree.map(jnp.asarray, st.GaussianScene(
        **{k: inp[f"r_{k}"] for k in FIELDS}))
    jcams = jax_orbit(st.Camera.create(
        h=H, w=H, position=(0.0, 0.0, 4.0)), 4, yaw_sweep=0.6)
    ref["jax_dense"] = np.asarray(jax.jit(jax.vmap(
        lambda c: st.render_dense(jscene, c, st.RenderConfig())))(jcams))
    scene = _tscene(inp, "r")
    views = stt.orbit_trajectory(stt.Camera.create(
        h=H, w=H, position=(0.0, 0.0, 4.0), device="cpu"), 4, yaw_sweep=0.6)
    ref["tiled"] = np.stack([stt.render_tiled(scene, c).numpy()
                             for c in views])
    ref["tiled_knobs"] = stt.render_tiled(scene, views[0], stt.RenderConfig(
        cull_pairs=True, subtile_exit=True, subtile_heavy_pairs=0)).numpy()
    ref["dense"] = np.stack([stt.render_dense(scene, c).numpy()
                             for c in views])

    gscene = _tscene(inp, "g")
    leaves = {k: getattr(gscene, k).clone().requires_grad_(True)
              for k in FIELDS}
    img = stt.render_tiled_diff(stt.GaussianScene(**leaves), views[0],
                                stt.RenderConfig(sh_degree=0,
                                                 max_dup_factor=8.0))
    torch.mean((img - 0.25) ** 2).backward()
    ref["tp_img"] = img.detach().numpy()
    ref["tp_grads"] = {k: leaves[k].grad.numpy() for k in FIELDS}

    cfg = stt.RenderConfig(max_dup_factor=8.0, sh_degree=1)
    fcams = stt.orbit_trajectory(stt.Camera.create(
        h=FIT_HW, w=FIT_HW, position=(0.0, 0.0, 4.0), device="cpu"), 4,
        yaw_sweep=0.6)
    targets = torch.from_numpy(inp["f_targets"])
    start = _tscene(inp, "f")
    ref["dp"] = stt.fit(start, stt.stack_cameras([c.to_se3() for c in fcams]),
                        targets, steps=3, method="tiled", config=cfg)
    ref["dp_densify"] = stt.fit(start, fcams, targets, steps=2,
                                method="tiled", config=cfg, densify_every=1)
    ref["dp_ss2"] = stt.fit(start, fcams, targets, steps=2, method="tiled",
                            config=stt.RenderConfig(max_dup_factor=8.0,
                                                    sh_degree=1,
                                                    supersample=2))
    ref["tp"] = stt.fit(start.pad_to(int(inp["f_padded_n"])), fcams,
                        targets, steps=3, method="tiled", config=cfg)
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the world of 4 and the dryrun at world 2, compute the
    references meanwhile, then collect every rank's results."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    inp, proj = _inputs()
    np.savez(tmp / "in.npz", **inp)
    ranks = dryrun.start_ranks(
        [sys.executable, WORKER, "--inputs", str(tmp / "in.npz"),
         "--out", str(tmp / "out")], WORLD, "cpu", str(tmp / "store"))
    dry = subprocess.Popen(
        [sys.executable, "-m", "splat_tpu_torch.parallel.dryrun", "--world",
         "2", "--device", "cpu", "--timeout", "120"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ref = _references(inp, proj)
    finally:
        dryrun.join_ranks(ranks, timeout=240)
        dry_out, dry_err = dry.communicate(timeout=240)
    ref["dryrun"] = (dry.returncode, dry_out + dry_err)
    outs = [dict(np.load(tmp / f"out_{r}.npz")) for r in range(WORLD)]
    return inp, ref, outs


# ---- a. scene helpers ---------------------------------------------------

@pytest.mark.parametrize("op", ["pad_to", "slice", "permuted"])
def test_scene_helpers_equal_splat_tpu(op):
    d = st.random_scene(37, seed=2).to_numpy()
    js = st.GaussianScene(**d)
    ts = stt.GaussianScene.from_numpy(d, device="cpu")
    call = {"pad_to": lambda s: s.pad_to(48),
            "slice": lambda s: s.slice(5, 30),
            "permuted": lambda s: s.permuted(seed=4)}[op]
    want, got = call(js), call(ts)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    with pytest.raises(ValueError):
        ts.pad_to(10)


# ---- b. sharding safety -------------------------------------------------

@pytest.mark.parametrize("order", ["random", "y_sorted"])
@pytest.mark.parametrize("n_g", [2, 4, 8])
def test_spatial_score_and_cap_equal_splat_tpu(order, n_g):
    from splat_tpu.parallel import sharding as jsh
    d = st.random_scene(1024, seed=9, extent=2.0,
                        scale_range=(0.02, 0.06)).to_numpy()
    if order == "y_sorted":
        d = {k: v[np.argsort(d["means"][:, 1], kind="stable")]
             for k, v in d.items()}
    js = st.GaussianScene(**d)
    ts = stt.GaussianScene.from_numpy(d, device="cpu")
    # splat_tpu's cache is keyed by id(): a scene of an earlier case, freed,
    # can hand its id and its factor to this one
    jsh._CAP_FACTOR_CACHE.clear()
    assert sharding.shard_spatial_score(ts, n_g) == \
        jsh.shard_spatial_score(js, n_g)
    assert sharding._auto_cap_factor(ts, n_g) == \
        jsh._auto_cap_factor(js, n_g)
    got, got_p = sharding.prepare_scene_for_sharding(ts, n_g, seed=3)
    want, want_p = jsh.prepare_scene_for_sharding(js, n_g, seed=3)
    assert got_p == want_p
    assert got_p == (order == "y_sorted" and n_g >= 4)  # y-sorted: ~1/n_g
    np.testing.assert_array_equal(got.means.numpy(), np.asarray(want.means))


def test_make_mesh_checks_size():
    with pytest.raises(ValueError, match="mesh"):
        sharding.make_mesh(3, 3, device="cpu")


# ---- c. routing against splat_tpu --------------------------------------

@pytest.mark.parametrize("rank", range(WORLD))
def test_a2a_routing_equals_splat_tpu(world, rank):
    """The port's records, validity and overflow equal splat_tpu's
    routing of the same fields, but for the gate: the port's reaches a
    pixel past the ceil-quantized radius, so splat_tpu is given those
    radii and the port's received y-radii are compared through the same
    map."""
    inp, ref, outs = world
    rows, visible, overflow = ref["routing"]
    out = outs[rank]
    got = out["route_rows"].copy()
    vis = out["route_visible"]
    got[vis, 6] = _port_gate_radius(got[vis, 5:7], vis[vis])
    np.testing.assert_array_equal(got, rows[rank])
    np.testing.assert_array_equal(out["route_visible"], visible[rank])
    assert int(out["route_ov"]) == int(overflow[rank]) > 0
    assert int(out["route_checked_raises"]) == 1


# ---- d. renders -------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("path", ["dense", "dense_batch", "gather",
                                  "gather_batch", "a2a", "a2a_batch",
                                  "checked", "checked_batch", "se3_batch",
                                  "se3_dense_batch"])
def test_sharded_render(world, mesh, path):
    """>= 45 dB against splat_tpu's dense render and the limits of
    _close_to_port against the single-device port, on every rank."""
    _, ref, outs = world
    port = ref["dense" if "dense" in path else "tiled"]
    for out in outs:
        got = out[f"{mesh}_{path}"]
        frames = got if got.ndim == 4 else got[None]
        assert frames.shape[1:] == (H, H, 3)
        for i, img in enumerate(frames):
            assert _psnr(img, ref["jax_dense"][i]) >= 45.0
            _close_to_port(img, port[i])
        if path in ("gather", "a2a", "gather_batch", "a2a_batch"):
            assert int(out[f"{mesh}_{path}_ov"]) == 0
        np.testing.assert_array_equal(got, outs[0][f"{mesh}_{path}"])


def test_sharded_render_with_cull_and_subtile_exit(world):
    """render_sharded_tiled at g = 2 with cull_pairs and subtile_exit on
    (every tile on the grouped walk): the slabs reach both knobs through
    the single-device binning and compositing, and agree with the
    single-device render under the same knobs, as _close_to_port holds."""
    _, ref, outs = world
    for out in outs:
        _close_to_port(out["2x2_knobs"], ref["tiled_knobs"])
        np.testing.assert_array_equal(out["2x2_knobs"], outs[0]["2x2_knobs"])
    _close_to_port(ref["tiled_knobs"], ref["tiled"][0])


def test_sharded_render_of_packed_scene(world):
    """render_sharded_tiled at g = 2 on each rank's shard of the packed
    scene (the buffer's columns, shard_scene's DeviceScene path) equals
    the render of the unpacked shard, bit for bit, by both routes."""
    for out in world[2]:
        for route in ("gather", "a2a"):
            np.testing.assert_array_equal(out[f"2x2_packed_{route}"],
                                          out[f"2x2_{route}"])


@pytest.mark.parametrize("mesh", MESHES)
def test_a2a_equals_gather(world, mesh):
    """Both routes gate with _slab_view's gate, so they keep the same
    pairs and render the same image, bit for bit, though many of this
    scene's splats reach a slab only through the quantized radius
    (counted here at the edges of the 4 slabs)."""
    inp, _, outs = world
    scene = _tscene(inp, "r")
    edge = 0
    for cam in stt.orbit_trajectory(stt.Camera.create(
            h=H, w=H, position=(0.0, 0.0, 4.0), device="cpu"), 4,
            yaw_sweep=0.6):
        p = port_project(scene, cam, stt.RenderConfig())
        cy, ry = p.center_px[:, 1], p.radius_px[:, 1]
        for row0 in range(0, H, H // WORLD):
            unquantized = (cy + ry > row0) & (cy - ry < row0 + H // WORLD)
            gated = sharding._slab_view(p, row0, H // WORLD).visible
            edge += int((gated & ~unquantized).sum())
    assert edge > 0
    for out in outs:
        for path in ("", "_batch"):
            np.testing.assert_array_equal(out[f"{mesh}_a2a{path}"],
                                          out[f"{mesh}_gather{path}"])


def test_a2a_cap_memo_agrees_across_ranks(world):
    """Rank 0 alone scores 300 other scenes between two a2a renders of one
    shard: every rank still hits the shard's memo and skips the gather."""
    _, _, outs = world
    assert [int(out["cap_memo_equal"]) for out in outs] == [1] * WORLD


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_edge_cases(world, mesh):
    """N = 0 renders pure background; depth mode needs depth_range; a
    mesh that does not fit the world, or CUDA tensors on gloo, raise."""
    for out in world[2]:
        for key in ("empty", "empty_dense"):
            np.testing.assert_allclose(
                out[f"{mesh}_{key}"], np.broadcast_to(
                    [0.2, 0.4, 0.6], (2, H, H, 3)), atol=1e-6)
        assert int(out[f"{mesh}_depth_raises"]) == 1
        assert int(out["mesh_3x3_raises"]) == 1
        assert int(out["cuda_on_gloo_raises"]) == 1


# ---- e. TP gradients --------------------------------------------------

@pytest.mark.parametrize("field", FIELDS)
def test_tp_gradients_equal_single_device(world, field):
    """render_slab_tiled_diff at g = 4 against render_tiled_diff: the
    forward within the slab limits, the gradient within 1e-4 relative L2
    and its norm within 1e-4 (an n_g-times gradient would be 4x)."""
    _, ref, outs = world
    _close_to_port(outs[0]["tp_img"], ref["tp_img"])
    got = np.concatenate([o[f"tp_grad_{field}"] for o in outs])
    want = ref["tp_grads"][field]
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 1e-4, err
    ratio = np.linalg.norm(got) / np.linalg.norm(want)
    assert 0.9999 <= ratio <= 1.0001, ratio


# ---- f. DP and TP fit -------------------------------------------------

@pytest.mark.parametrize("case", ["dp", "dp_densify", "dp_ss2", "tp"])
def test_parallel_fit_equals_single_device(world, case):
    _, ref, outs = world
    want = ref[case]
    for out in outs:
        got = out[f"{case}_losses"]
        np.testing.assert_allclose(got, want.losses.numpy(), rtol=1e-5)
        if case == "dp_densify":
            assert json.loads(str(out["dp_densify_log"])) == \
                [dict(s) for s in want.densify_log]
            assert len(want.densify_log) == 1
        else:
            np.testing.assert_allclose(out[f"{case}_means"],
                                       want.scene.means.numpy(),
                                       rtol=1e-4, atol=1e-6)


def test_dp_fit_keeps_no_exchange_buffer(world):
    """Each step's loss that fit keeps owns 4 bytes, not the all-reduced
    buffer of every gradient it came from; the exchange counts one call
    of (the leaves' numel + 1) x 4 bytes a step."""
    _, _, outs = world
    for out in outs:
        np.testing.assert_array_equal(out["dp_kept_loss_bytes"], [4, 4])
        calls, nbytes = out["dp_exchange"]
        assert calls == 3
        assert nbytes == 3 * (int(out["dp_numel"]) + 1) * 4


# ---- g. the dryrun entry point ----------------------------------------

def test_dryrun_world_2_cpu(world):
    code, text = world[1]["dryrun"]
    assert code == 0, text[-4000:]
    assert "dryrun_multichip OK: mesh=(d=2, g=1) on cpu" in text
