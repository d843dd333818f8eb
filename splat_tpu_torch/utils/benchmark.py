"""On-card frame benchmark (counterpart of ``splat_tpu/utils/benchmark.py``).

Times a yaw sweep of tiled renders, one captured CUDA graph as
``splat_tpu`` times one jitted ``lax.scan``, with CUDA events, then audits
the pair load over the SAME sweep: a frame that overflowed its duplication
buffer dropped pairs, and a capacity regression would otherwise look like
a speedup.  Needs a CUDA device; there is no CPU fallback.

Where the device time of the 1M @1080p cells goes, on one card:

    python -m splat_tpu_torch.utils.benchmark frame --scene surface
    python -m splat_tpu_torch.utils.benchmark train --scene surface

(one JSON object on stdout, with the card's name).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from splat_tpu_torch.render import graph
from splat_tpu_torch.render.tiled import render_tiled


def _sweep_fns(config, frames: int):
    """The two programs of a sweep, as ``splat_tpu``'s ``chained_bench``
    scans them: ``sweep(scene, camera)`` renders ``frames`` frames at yaw
    + 0.01 i, each pose computed on the card and each frame depending on
    the one before (its mean image times 1e-20 joins the next yaw), and
    returns the (frames,) mean pixels; ``audit(scene, camera)`` renders
    the same poses with their stats and returns the sweep-max overflow,
    num_pairs and visible, a (3,) int64 tensor."""
    def yaw_steps(camera):
        return 0.01 * torch.arange(frames, dtype=torch.float32,
                                   device=camera.yaw.device)

    def sweep(scene, camera):
        steps = yaw_steps(camera)
        carry = torch.zeros((), dtype=torch.float32, device=steps.device)
        means = []
        for i in range(frames):
            cam = dataclasses.replace(
                camera, yaw=camera.yaw + steps[i] + carry * 1e-20)
            carry = render_tiled(scene, cam, config).mean()
            means.append(carry)
        return torch.stack(means)

    def audit(scene, camera):
        steps = yaw_steps(camera)
        rows = []
        for i in range(frames):
            cam = dataclasses.replace(camera, yaw=camera.yaw + steps[i])
            _, st = render_tiled(scene, cam, config, return_stats=True)
            rows.append(torch.stack([st["overflow"], st["num_pairs"],
                                     st["visible"]]))
        return torch.stack(rows).amax(0)

    return sweep, audit


def _program(fn, scene, camera, compiled: bool):
    """``fn`` as one captured CUDA graph (``render/graph.py::capture``)
    or, with ``compiled`` off, as it is, with the seconds the capture
    took (0.0 for the eager form)."""
    if not compiled:
        return fn, 0.0
    prog = graph.capture(fn, scene, camera)
    return prog, prog.capture_s


def chained_bench(scene, camera, config, frames: int, *,
                  compiled: bool = True) -> dict:
    """Time ``frames`` renders at yaw + 0.01 * i as one program; audit
    their pair load over the same sweep.  ``scene`` is what
    ``render_tiled`` takes: ``bench.py`` and the command line give the
    packed ``DeviceScene`` (``pack_device()``).

    compiled: the sweep and the audit are each one captured CUDA graph,
      as ``splat_tpu`` jits each one ``lax.scan``; the timed window is one
      replay, between CUDA events, with no host sync inside.  Off: the
      same sweep dispatched eagerly, launch by launch, from the host.

    Returns ms_per_frame, fps, warmup_s (one eager frame, kernel build
    included), compile_s (``splat_tpu``'s key: here the capture and
    instantiation of the timed sweep, 0.0 when not compiled), mean_pixel,
    and the sweep-max overflow / num_pairs / visible.  The fps number is
    only honest when overflow == 0.
    """
    if scene.device.type != "cuda":
        raise RuntimeError("chained_bench measures the card: put the scene "
                           "on a CUDA device")
    camera = camera.to(scene.device)
    t0 = time.perf_counter()
    render_tiled(scene, camera, config)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    sweep, audit = _sweep_fns(config, frames)
    sweep, compile_s = _program(sweep, scene, camera, compiled)
    audit, _ = _program(audit, scene, camera, compiled)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    means = sweep(scene, camera)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / frames

    overflow, num_pairs, visible = (int(x) for x in audit(scene, camera))
    return {
        "ms_per_frame": ms,
        "fps": 1000.0 / ms,
        "warmup_s": warmup_s,
        "compile_s": compile_s,
        "mean_pixel": float(means.mean()),
        "overflow": overflow,
        "num_pairs": num_pairs,
        "visible": visible,
    }


def _device_profile(run, count: int, top: int) -> dict:
    """Run ``run()`` once under ``torch.profiler``; per ``count`` units of
    work: wall ms, device-busy ms, idle share and the ``top`` kernels by
    self device time.  The profiler's own overhead inflates the wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / count
    per_kernel: dict[str, float] = {}
    for evt in prof.key_averages():
        # kernels only: host ops also report the device time they caused
        if evt.device_type == DeviceType.CUDA:
            per_kernel[evt.key] = (per_kernel.get(evt.key, 0.0)
                                   + evt.self_device_time_total)
    busy_ms = sum(per_kernel.values()) / 1e3 / count
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_ms": {k: v / 1e3 / count for k, v in ranked},
    }


def profile_frames(scene, camera, config, frames: int = 10,
                   top: int = 15, *, compiled: bool = True) -> dict:
    """Where a frame's device time goes: the same yaw sweep under
    ``torch.profiler``, on ``scene`` as given (``main`` packs it), as one
    captured graph or, with ``compiled`` off, dispatched eagerly (see
    :func:`chained_bench`).  Returns per frame: the wall and device-busy
    ms, the device's idle share, and the ``top`` kernels by self device
    time.
    """
    if scene.device.type != "cuda":
        raise RuntimeError("profile_frames measures the card: put the scene "
                           "on a CUDA device")
    camera = camera.to(scene.device)
    sweep, _ = _sweep_fns(config, frames)
    sweep, _ = _program(sweep, scene, camera, compiled)
    sweep(scene, camera)
    return _device_profile(lambda: sweep(scene, camera), frames, top)


def profile_fit_steps(scene, cameras, targets, config, steps: int = 3,
                      top: int = 15, **fit_kwargs) -> dict:
    """Where a training step's device time goes: ``fit(method="tiled")``
    for ``steps`` steps under ``torch.profiler``, after a one-step warm-up.
    Returns the same keys as :func:`profile_frames`, per step (fit's
    set-up, one capacity audit, is inside the wall time)."""
    from splat_tpu_torch.train import fit

    if scene.device.type != "cuda":
        raise RuntimeError("profile_fit_steps measures the card: put the "
                           "scene on a CUDA device")

    def run(n=steps):
        fit(scene, cameras, targets, steps=n, config=config, method="tiled",
            **fit_kwargs)

    run(1)
    return _device_profile(run, steps, top)


def main(argv=None) -> int:
    import argparse
    import json

    from splat_tpu_torch.camera import Camera, orbit_trajectory
    from splat_tpu_torch.config import RenderConfig
    from splat_tpu_torch.render.api import render
    from splat_tpu_torch.utils.fixtures import random_scene, surface_scene

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("frame", "train"))
    ap.add_argument("--scene", choices=("random", "surface"),
                    default="surface")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--h", type=int, default=1080)
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--frames", type=int, default=30,
                    help="frames of each timed sweep (frame)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA device")
    dev = torch.device("cuda", 0)
    # the headline cells of the repo's bench.py; training audits its pair
    # capacity with a 5% margin, which random's inference 2.05 lacks
    if args.scene == "surface":
        scene, dup = surface_scene(args.n, seed=0, device=dev), 1.45
    else:
        scene = random_scene(args.n, seed=0, extent=3.0,
                             scale_range=(0.004, 0.03), device=dev)
        dup = 2.2 if args.what == "train" else 2.05
    cfg = RenderConfig(max_dup_factor=dup)
    cam = Camera.create(h=args.h, w=args.w, position=(0.0, 0.0, 4.0),
                        device=dev)
    if args.what == "frame":
        # bench.py times packed scenes: the frame reads the feature-major
        # layout.  The sweep's wall time without the profiler, then its
        # profile
        scene = scene.pack_device()
        sweeps = [chained_bench(scene, cam, cfg, args.frames)
                  for _ in range(3)]
        if any(s["overflow"] for s in sweeps):
            raise SystemExit(f"benchmark: overflow {sweeps[0]['overflow']}")
        out = profile_frames(scene, cam, cfg, top=30)
        out = {"sweep_ms_per_frame": [s["ms_per_frame"] for s in sweeps],
               "sweep_frames": args.frames,
               "num_pairs": sweeps[0]["num_pairs"], **out,
               "idle_share_of_median_sweep": 1.0 - out["device_busy_ms"]
               / sorted(s["ms_per_frame"] for s in sweeps)[1]}
    else:
        cams = orbit_trajectory(cam, args.views, yaw_sweep=0.05)
        targets = torch.stack([render(scene, c, cfg) for c in cams])
        start = dataclasses.replace(scene, sh=scene.sh * 0.8)
        out = profile_fit_steps(start, cams, targets, cfg, steps=args.steps,
                                lr=5e-3, l1_weight=0.2, dssim_weight=0.2)
    # kernel names cut to a readable length (PyTorch's run to 1,000
    # characters); names that then coincide are added up
    short: dict[str, float] = {}
    for name, ms in out["kernels_ms"].items():
        key = name if len(name) <= 100 else name[:100] + "..."
        short[key] = short.get(key, 0.0) + ms
    out["kernels_ms"] = short
    out = {"device": torch.cuda.get_device_name(0), "what": args.what,
           "scene": args.scene, "n": args.n, "h": args.h, "w": args.w,
           **({"views": args.views, "steps": args.steps}
              if args.what == "train" else {}), **out}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
