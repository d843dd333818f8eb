"""On-card frame benchmark (counterpart of ``splat_tpu/utils/benchmark.py``).

Times a yaw sweep of tiled renders, one captured CUDA graph as
``splat_tpu`` times one jitted ``lax.scan``, with CUDA events, then audits
the pair load over the SAME sweep: a frame that overflowed its duplication
buffer dropped pairs, and a capacity regression would otherwise look like
a speedup.  Needs a CUDA device; there is no CPU fallback.
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

