"""Observability (port of ``splat_tpu.utils.diagnostics``).

* :func:`profile_trace`: a ``torch.profiler`` trace of the enclosed block,
  written into a directory as a Chrome trace (the CLI's ``--profile``);
* :func:`scene_health`: NaN/Inf/range audit of a scene's arrays;
* :func:`frame_report`: one tiled frame's statistics (visible count, pair
  count, tile occupancy, overflow);
* :class:`StageTimer`: host-clock stage timing, fenced with
  ``torch.cuda.synchronize()`` on a CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch

from splat_tpu_torch.device import resolve_device


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Profile the enclosed block (host ops, and the card's kernels where
    there is a card) and write ``trace_<pid>_<ns>.json`` into ``logdir``
    (open it in chrome://tracing or Perfetto).  A profiler that cannot
    start raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def scene_health(scene) -> dict:
    """Audit a scene for data problems (host side).  Per field: nan and inf
    counts; plus huge scales, opacities outside [0, 1] and unnormalised
    quaternions.  ``ok`` is True when the scene renders as it is."""
    d = scene.to_numpy()
    report: dict = {"ok": True, "num_gaussians": int(scene.num_gaussians)}
    for name, arr in d.items():
        nan = int(np.isnan(arr).sum())
        inf = int(np.isinf(arr).sum())
        if nan or inf:
            report["ok"] = False
        report[name] = {"nan": nan, "inf": inf}
    if scene.num_gaussians:
        report["scales"]["huge"] = int((d["scales"] > 1e3).sum())
        report["opacities"]["out_of_range"] = int(
            ((d["opacities"] < 0) | (d["opacities"] > 1)).sum())
        qn = np.linalg.norm(d["quats"], axis=1)
        report["quats"]["unnormalized"] = int(
            (np.abs(qn - 1.0) > 1e-3).sum())
        if (report["opacities"]["out_of_range"]
                or report["quats"]["unnormalized"]):
            report["ok"] = False
    return report


def frame_report(scene, camera, config=None) -> dict:
    """Render one tiled frame with its statistics and return them on the
    host: ``render_tiled``'s stats (num_pairs, overflow, visible,
    max_tile_pairs, mean_tile_pairs) plus the image's height, width, mean
    pixel and share of non-black pixels."""
    from splat_tpu_torch.render.tiled import render_tiled

    with torch.inference_mode():
        img, stats = render_tiled(scene, camera, config, return_stats=True)
    report = {k: float(v) for k, v in stats.items()}
    report.update({
        "height": img.shape[0], "width": img.shape[1],
        "mean_pixel": float(img.mean()),
        "nonzero_pixel_frac": float((img.amax(-1) > 0).float().mean()),
    })
    return report


class StageTimer:
    """Host-clock stage timing; on a CUDA device each stage ends with
    ``torch.cuda.synchronize()``, so its time includes the device work it
    queued.  For per-kernel device time use :func:`profile_trace`."""

    def __init__(self, device=None):
        """device: what the stages run on (None = cuda:0, raising without
        a CUDA device)."""
        self.device = resolve_device(device)
        self.times: dict[str, float] = {}

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._fence()
        t0 = time.perf_counter()
        yield
        self._fence()
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.times.values()) or 1.0
        return "\n".join(
            f"{k:>12}: {v * 1e3:8.2f} ms ({v / total * 100:4.1f}%)"
            for k, v in self.times.items())
