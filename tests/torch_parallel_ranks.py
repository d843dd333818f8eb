"""One rank of the CPU world that tests/test_torch_parallel.py starts.

Imports torch and splat_tpu_torch only (no JAX): the test module writes the
inputs to an .npz, starts its ranks with
``splat_tpu_torch.parallel.dryrun.start_ranks``, and compares what each rank
writes to ``<out>_<rank>.npz`` with the single-device port and splat_tpu.

    python tests/torch_parallel_ranks.py --inputs IN.npz --out PREFIX \
        --rank R --world 4 --init-file FILE --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import splat_tpu_torch as stt  # noqa: E402
from splat_tpu_torch import train  # noqa: E402
from splat_tpu_torch.ops.projection import ProjectedGaussians  # noqa: E402
from splat_tpu_torch.parallel import dryrun, sharding  # noqa: E402

FIELDS = ("means", "quats", "scales", "opacities", "sh")


def scene_of(inp, prefix: str):
    return stt.GaussianScene.from_numpy(
        {k: inp[f"{prefix}_{k}"] for k in FIELDS}, device="cpu")


def cams(inp, prefix: str) -> list:
    """The test's cameras: orbit views, or their SE(3) forms."""
    h, w, n, sweep, se3 = inp[f"{prefix}_cams"]
    cam = stt.Camera.create(h=int(h), w=int(w), position=(0.0, 0.0, 4.0),
                            device="cpu")
    views = stt.orbit_trajectory(cam, int(n), yaw_sweep=float(sweep))
    if se3:
        views = stt.stack_cameras([c.to_se3() for c in views])
    return views


def raises(fn, exc) -> int:
    try:
        fn()
    except exc:
        return 1
    return 0


def renders(inp, out: dict, rank: int) -> None:
    """Case d: every render path at (1, 4) and (2, 2)."""
    scene = scene_of(inp, "r")
    cam, views = cams(inp, "r")[0], cams(inp, "r")
    se3_views = cams(inp, "r_se3")
    cfg = stt.RenderConfig()
    empty = stt.GaussianScene.from_numpy(
        {k: np.zeros((0,) + inp[f"r_{k}"].shape[1:], np.float32)
         for k in FIELDS}, device="cpu")
    bg_cfg = stt.RenderConfig(background=(0.2, 0.4, 0.6))
    for shape in ((1, 4), (2, 2)):
        mesh = sharding.make_mesh(*shape, device="cpu")
        local = sharding.shard_scene(scene, mesh)
        t = f"{shape[0]}x{shape[1]}"
        out[f"{t}_dense"] = sharding.render_sharded(local, cam, mesh, cfg)
        out[f"{t}_dense_batch"] = sharding.render_batch_sharded(
            local, views, mesh, cfg)
        for route in ("gather", "a2a"):
            img, ov = sharding.render_sharded_tiled(local, cam, mesh, cfg,
                                                    route=route)
            imgs, ovb = sharding.render_batch_sharded_tiled(
                local, views, mesh, cfg, route=route)
            out[f"{t}_{route}"], out[f"{t}_{route}_ov"] = img, ov
            out[f"{t}_{route}_batch"] = imgs
            out[f"{t}_{route}_batch_ov"] = ovb
        out[f"{t}_checked"] = sharding.render_sharded_tiled_checked(
            local, cam, mesh, cfg)
        out[f"{t}_checked_batch"] = (
            sharding.render_batch_sharded_tiled_checked(local, views, mesh,
                                                        cfg))
        # SE(3) views through stack_cameras as the batched cameras
        out[f"{t}_se3_batch"] = sharding.render_batch_sharded_tiled(
            local, se3_views, mesh, cfg)[0]
        out[f"{t}_se3_dense_batch"] = sharding.render_batch_sharded(
            local, se3_views, mesh, cfg)
        # N = 0: pure background on every path
        out[f"{t}_empty"] = torch.stack([
            sharding.render_sharded_tiled(empty, cam, mesh, bg_cfg)[0],
            sharding.render_batch_sharded_tiled(empty, views, mesh,
                                                bg_cfg)[0][1]])
        out[f"{t}_empty_dense"] = torch.stack([
            sharding.render_sharded(empty, cam, mesh, bg_cfg),
            sharding.render_batch_sharded(empty, views, mesh, bg_cfg)[2]])
        if shape == (2, 2):
            # the shard of the packed scene, by both routes
            packed = sharding.shard_scene(scene.pack_device(), mesh)
            for route in ("gather", "a2a"):
                out[f"{t}_packed_{route}"] = sharding.render_sharded_tiled(
                    packed, cam, mesh, cfg, route=route)[0]
            # g = 2 with both of K1's and K2's walk knobs on
            out[f"{t}_knobs"] = sharding.render_sharded_tiled(
                local, cam, mesh, stt.RenderConfig(
                    cull_pairs=True, subtile_exit=True,
                    subtile_heavy_pairs=0))[0]
        out[f"{t}_depth_raises"] = raises(
            lambda: sharding.render_sharded_tiled(
                local, cam, mesh, stt.RenderConfig(render_mode="depth")),
            ValueError)
    # the a2a cap is memoized on the shard object: rank 0 alone scoring
    # 300 other scenes (past the 256 entries a table of the process would
    # hold before emptying) must not make it miss alone and enter the
    # score's gather that the others skip
    mesh = sharding.make_mesh(1, 4, device="cpu")
    local = sharding.shard_scene(scene, mesh)
    first = sharding.render_sharded_tiled(local, cam, mesh, cfg,
                                          route="a2a")[0]
    if rank == 0:
        for _ in range(300):
            sharding._auto_cap_factor(scene.slice(0, 64), 4)
    again = sharding.render_sharded_tiled(local, cam, mesh, cfg,
                                          route="a2a")[0]
    out["cap_memo_equal"] = int(torch.equal(first, again))
    out["mesh_3x3_raises"] = raises(lambda: sharding.make_mesh(3, 3,
                                                               device="cpu"),
                                    ValueError)
    out["cuda_on_gloo_raises"] = raises(
        lambda: sharding.make_mesh(1, 4, device="cuda"), ValueError)


def routing(inp, out: dict, rank: int) -> None:
    """Case c: the a2a routing of splat_tpu's projected fields, a cap
    that overflows; and the checked render raising on it."""
    mesh = sharding.make_mesh(1, 4, device="cpu")
    group = mesh.get_group("g")
    n = inp["p_depth"].shape[0] // 4
    sl = slice(rank * n, (rank + 1) * n)
    t = {k: torch.from_numpy(np.ascontiguousarray(inp[f"p_{k}"][sl]))
         for k in ("depth", "center_px", "conic", "radius_px", "color",
                   "opacity", "visible")}
    proj = ProjectedGaussians(**t)
    h_local = int(inp["p_h"]) // 4
    # tiles of the slab's height: each destination's frame is its own
    # rows, the gate splat_tpu routes with
    rec, ov = sharding._route_records_by_slab(
        proj, 4, h_local, float(inp["p_cap_factor"]), group, h_local)
    out["route_rows"] = torch.cat([
        rec.center_px, rec.conic, rec.radius_px, rec.color,
        rec.opacity[:, None], rec.depth[:, None]], dim=1)
    out["route_visible"] = rec.visible
    out["route_ov"] = ov
    scene = sharding.shard_scene(scene_of(inp, "p"), mesh)
    cam = cams(inp, "p")[0]
    out["route_checked_raises"] = raises(
        lambda: sharding.render_sharded_tiled_checked(
            scene, cam, mesh, stt.RenderConfig(), route="a2a",
            slab_cap_factor=float(inp["p_cap_factor"])), RuntimeError)


def tp_gradients(inp, out: dict, rank: int) -> None:
    """Case e: render_slab_tiled_diff at g = 4, its forward and the
    gradients of its shard."""
    mesh = sharding.make_mesh(1, 4, device="cpu")
    local = sharding.shard_scene(scene_of(inp, "g"), mesh)
    leaves = {k: getattr(local, k).clone().requires_grad_(True)
              for k in FIELDS}
    cfg = stt.RenderConfig(sh_degree=0, max_dup_factor=8.0)
    img = sharding.render_slab_tiled_diff(stt.GaussianScene(**leaves),
                                          cams(inp, "g")[0], cfg, mesh)
    torch.mean((img - 0.25) ** 2).backward()
    out["tp_img"] = img.detach()
    for k in FIELDS:
        out[f"tp_grad_{k}"] = leaves[k].grad


def exchange_counters() -> tuple:
    """(calls, bytes) of fit's gradient exchange so far, (-1, -1) where
    the program keeps no such counters."""
    avg = train._Mesh.average
    return getattr(avg, "calls", -1), getattr(avg, "bytes", -1)


def kept_loss_bytes(run_fit) -> np.ndarray:
    """The bytes of storage behind the loss each step of ``run_fit()``
    took from the exchange, which fit keeps until it returns."""
    real, kept = train._Mesh.average, []

    def average(self, grads, loss):
        grads, loss = real(self, grads, loss)
        kept.append(loss.untyped_storage().nbytes())
        return grads, loss
    # the counters the exchange bumps through its class attribute
    average.calls, average.bytes = 0, 0
    train._Mesh.average = average
    try:
        run_fit()
    finally:
        train._Mesh.average = real
    return np.array(kept)


def fits(inp, out: dict, rank: int) -> None:
    """Case f: data-parallel fit at (4, 1) (SE(3) views; then with
    densification; then supersampled) and tensor-parallel fit at (1, 4)."""
    cfg = stt.RenderConfig(max_dup_factor=8.0, sh_degree=1)
    targets = torch.from_numpy(inp["f_targets"])
    start = scene_of(inp, "f")
    mesh41 = sharding.make_mesh(4, 1, device="cpu")
    counted = exchange_counters()
    res = stt.fit(start, cams(inp, "f_se3"), targets, steps=3,
                  method="tiled", config=cfg, mesh=mesh41)
    out["dp_losses"] = res.losses
    out["dp_means"] = res.scene.means
    out["dp_exchange"] = np.array(exchange_counters()) - np.array(counted)
    out["dp_numel"] = np.array(sum(
        getattr(start, k).numel() for k in FIELDS))
    out["dp_kept_loss_bytes"] = kept_loss_bytes(
        lambda: stt.fit(start, cams(inp, "f"), targets, steps=2,
                        method="tiled", config=cfg, mesh=mesh41))
    res = stt.fit(start, cams(inp, "f"), targets, steps=2, method="tiled",
                  config=cfg, mesh=mesh41, densify_every=1)
    out["dp_densify_losses"] = res.losses
    out["dp_densify_log"] = np.array(json.dumps(res.densify_log))
    # supersampling: each rank's views rendered whole, not by slab
    res = stt.fit(start, cams(inp, "f"), targets, steps=2, method="tiled",
                  config=dataclasses.replace(cfg, supersample=2),
                  mesh=mesh41)
    out["dp_ss2_losses"] = res.losses
    out["dp_ss2_means"] = res.scene.means
    mesh14 = sharding.make_mesh(1, 4, device="cpu")
    padded = scene_of(inp, "f").pad_to(int(inp["f_padded_n"]))
    res = stt.fit(padded, cams(inp, "f"), targets, steps=3, method="tiled",
                  config=cfg, mesh=mesh14)
    out["tp_losses"] = res.losses
    out["tp_means"] = res.scene.means


def main() -> int:
    ap = dryrun.rank_parser(__doc__.splitlines()[0])
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    dryrun.init_rank(args.rank, args.world, args.init_file, args.device)
    inp = dict(np.load(args.inputs))
    out: dict = {}
    try:
        for case in (routing, renders, tp_gradients, fits):
            case(inp, out, args.rank)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(f"{args.out}_{args.rank}.npz", **{
        k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
        for k, v in out.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
