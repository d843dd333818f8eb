"""One full multi-device step of every sharded path, on N ranks.

    python -m splat_tpu_torch.parallel.dryrun --world N [--device cpu]

starts N rank processes (``torch.distributed`` with a file store under a
temporary directory: NCCL on the card, one card a rank; gloo on the CPU),
each of which runs :func:`dryrun_multichip`, the twin of
``__graft_entry__.dryrun_multichip``: on a (d, g) mesh (d = 2 where N is
even and above 1), a dense batch, both tiled routes, a scene stored in
spatial order, the tiled batch, and one dense data-parallel, one tiled
data-parallel and one tensor-parallel training step.  Exits 0 when every
rank ran to its end.

:func:`start_ranks`, :func:`join_ranks` and :func:`init_rank` start,
join and enter such worlds for any per-rank script.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def init_rank(rank: int, world: int, init_file: str, device: str,
              timeout: float = 600.0) -> torch.device:
    """Join a world of ``world`` ranks through the file store
    ``init_file``: NCCL with card ``rank % cards`` (made the current
    device and bound to the process group) for ``device="cuda"``, gloo
    with one CPU thread for ``device="cpu"``.  A collective that waits
    longer than ``timeout`` seconds for a peer fails instead of blocking
    the rank forever.  Returns the rank's device."""
    kw = {}
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend, kw["device_id"] = "nccl", dev
    elif device == "cpu":
        torch.set_num_threads(1)
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout),
                            **kw)
    return dev


def start_ranks(argv: list, world: int, device: str,
                init_file: str) -> list:
    """Start ``argv + [--rank r --world N --init-file F --device D]`` for
    r in 0..N-1, each able to import this package, its standard error
    sent to ``rank_<r>.err`` beside ``init_file``; returns the processes
    (join them with :func:`join_ranks`).  On the card the kernels are
    built here first, so that the ranks load one library instead of each
    running ``nvcc``."""
    if device == "cuda":
        from splat_tpu_torch import _build
        _build.build()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_PARENT] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = []
    for r in range(world):
        err_path = os.path.join(os.path.dirname(os.path.abspath(init_file)),
                                f"rank_{r}.err")
        with open(err_path, "w") as err:
            p = subprocess.Popen(
                list(argv) + ["--rank", str(r), "--world", str(world),
                              "--init-file", init_file, "--device", device],
                env=env, stderr=err)
        p.err_path = err_path
        procs.append(p)
    return procs


def _tail(path: str, nbytes: int = 4000) -> str:
    with open(path, "rb") as f:
        f.seek(max(os.path.getsize(path) - nbytes, 0))
        return f.read().decode(errors="replace")


def join_ranks(procs: list, timeout: float) -> None:
    """Wait for every rank.  As soon as one exits non-zero the others are
    killed (they may be blocked in a collective that rank never joins)
    and this raises with that rank's standard error; so it does when the
    ranks outlive ``timeout`` seconds together."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if (failed is not None or None not in codes
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed is not None:
        raise RuntimeError(
            f"rank {failed} of {len(procs)} exited with code "
            f"{procs[failed].returncode}; its standard error ends:\n"
            f"{_tail(procs[failed].err_path)}")
    late = [r for r, p in enumerate(procs) if p.returncode != 0]
    if late:
        raise RuntimeError(
            f"ranks {late} of {len(procs)} still ran after {timeout} s; "
            f"rank {late[0]}'s standard error ends:\n"
            f"{_tail(procs[late[0]].err_path)}")


def rank_parser(description: str = "") -> argparse.ArgumentParser:
    """The arguments every rank process takes (and its launcher)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank", type=int, default=None,
                    help="set by the launcher for each rank it starts")
    ap.add_argument("--init-file", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    return ap


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, device) -> str:
    """Every sharded path once on the initialised world of ``n_devices``
    ranks, the scene, cameras and sizes of ``__graft_entry__``'s dryrun;
    called on every rank.  Returns the summary line."""
    import splat_tpu_torch as stt
    from splat_tpu_torch.parallel import sharding

    _require(dist.get_world_size() == n_devices,
             f"world of {dist.get_world_size()} ranks, not {n_devices}")
    n_data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = sharding.make_mesh(n_data, n_devices // n_data,
                              device=torch.device(device).type)
    n_g = n_devices // n_data
    scene = stt.random_scene(64 * n_g, seed=0, extent=2.0,
                             scale_range=(0.05, 0.2), device=device)
    local = sharding.shard_scene(scene, mesh)
    h = 8 * n_g  # rows divisible by the 'g' axis
    cam = stt.Camera.create(h=h, w=16, position=(0.0, 0.0, 4.0),
                            device=device)
    cams = stt.orbit_trajectory(cam, num_frames=2 * n_data)
    imgs = sharding.render_batch_sharded(local, cams, mesh,
                                         stt.RenderConfig(), chunk=8)
    _require(tuple(imgs.shape) == (2 * n_data, h, 16, 3), "dense batch")
    _require(bool(torch.isfinite(imgs).all()), "dense batch not finite")

    # the tiled path, each rank's slab binned (K1) and composited (K2),
    # the records gathered or routed to their slabs by an all_to_all
    cfg = stt.RenderConfig(chunk=128)
    h2 = 32 * n_g  # one 32 px tile row a rank
    cam2 = stt.Camera.create(h=h2, w=32, position=(0.0, 0.0, 4.0),
                             device=device)
    tiled = {}
    for route in ("a2a", "gather"):
        img, overflow = sharding.render_sharded_tiled(local, cam2, mesh, cfg,
                                                      route=route)
        _require(tuple(img.shape) == (h2, 32, 3), f"{route} shape")
        _require(bool(torch.isfinite(img).all()), f"{route} not finite")
        _require(int(overflow) == 0, f"{route} overflow {int(overflow)}")
        tiled[route] = img
    _require(torch.allclose(tiled["a2a"], tiled["gather"], atol=1e-5),
             "a2a routing disagrees with the gather")

    # a scene stored in spatial order: the score finds it (with more than
    # one shard) and the auto cap keeps the a2a route from dropping records
    order = torch.argsort(scene.means[:, 1])
    scene_sorted = stt.GaussianScene(**{
        k: getattr(scene, k)[order]
        for k in ("means", "quats", "scales", "opacities", "sh")})
    if n_g > 1:
        _require(sharding.shard_spatial_score(scene_sorted, n_g) < 0.5,
                 "the sorted scene's spatial score")
    img3, ov3 = sharding.render_sharded_tiled(
        sharding.shard_scene(scene_sorted, mesh), cam2, mesh, cfg,
        route="a2a")
    _require(int(ov3) == 0, "sorted-scene a2a overflowed")
    _require(float((img3 - tiled["gather"]).abs().max()) < 1e-2,
             "sorted-scene a2a image diverged from the unsorted render")

    cams2 = stt.orbit_trajectory(cam2, num_frames=2 * n_data)
    imgs2, ov = sharding.render_batch_sharded_tiled(local, cams2, mesh, cfg)
    _require(tuple(imgs2.shape) == (2 * n_data, h2, 32, 3), "tiled batch")
    _require(int(ov) == 0, "tiled batch overflow")

    # training: a dense data-parallel step, then two tiled steps, each
    # also tensor parallel (parameters sharded over 'g', with collectives
    # that are copies on a 'g' axis of one rank)
    rng = np.random.default_rng(7)
    jitter = torch.tensor(rng.normal(0.0, 0.05, (scene.num_gaussians, 3))
                          .astype(np.float32), device=device)
    start = dataclasses.replace(scene, means=scene.means + jitter)
    steps = {}
    for name, tgt, cs, kw in (
            ("dp_dense", imgs, cams, dict(method="dense",
                                          config=stt.RenderConfig())),
            ("dp_tiled", imgs, cams, dict(
                method="tiled", config=stt.RenderConfig(max_dup_factor=16.0))),
            ("tp", imgs2, cams2, dict(
                method="tiled",
                config=stt.RenderConfig(max_dup_factor=16.0, chunk=128)))):
        res = stt.fit(start, cs, tgt, steps=1, mesh=mesh, **kw)
        loss = float(res.losses[0])
        _require(np.isfinite(loss) and loss > 0, f"{name} loss {loss}")
        moved = float((res.scene.means - start.means).abs().max())
        _require(moved > 0, f"{name} step did not update the parameters")
        steps[name] = loss
    return (f"dryrun_multichip OK: mesh=(d={n_data}, g={n_g}) on {device}, "
            f"dense imgs={tuple(imgs.shape)}, tiled img={tuple(img3.shape)} "
            f"(a2a == gather), batch tiled imgs={tuple(imgs2.shape)}, "
            f"train step losses dp dense {steps['dp_dense']:.5f}, dp tiled "
            f"{steps['dp_tiled']:.5f}, tp {steps['tp']:.5f}")


def main(argv=None) -> int:
    args = rank_parser(__doc__.splitlines()[0]).parse_args(argv)
    if args.rank is None:       # the launcher: one process a rank
        with tempfile.TemporaryDirectory() as tmp:
            join_ranks(start_ranks(
                [sys.executable, "-m", "splat_tpu_torch.parallel.dryrun",
                 "--timeout", str(args.timeout)], args.world, args.device,
                os.path.join(tmp, "store")), args.timeout)
        return 0
    dev = init_rank(args.rank, args.world, args.init_file, args.device,
                    args.timeout)
    try:
        line = dryrun_multichip(args.world, dev)
        if args.rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
