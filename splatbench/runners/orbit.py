"""The ``orbit`` kind: one client in a closed loop, ``render(scene,
camera)`` with no config, each frame requested once the previous image
is complete on the card.

The set-up measures the pair load along one period of the path
(``pair_stats``) and renders the heaviest pose first, so that render()'s
automatic capacity is sized before the window and nothing is captured
inside it; then it runs the loop for ``settle_s`` seconds.  A traced run
renders the first ``trace_frames`` poses ``untraced_passes`` times on
the host clock, then once more under the profiler: the per-layer shares divide by the untraced time.  A sample of
the window's frames, drawn from the seed, is compared with the
reference's images at their poses.
"""

from __future__ import annotations

import random
import time
import traceback

import torch

from splatbench import check, drive, harness, poses, scenes, trace
from splatbench.reference import render as reference

FRAME_SPAN = "splatbench.frame"
QUARTERS = 4


class Sample:
    """A uniform sample of ``k`` of the frames offered, drawn from the
    seed (reservoir sampling): (index, image) pairs."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = random.Random(seed)

    def offer(self, index: int, img) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((index, img))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = (index, img)


def _quarters(lat: list) -> str:
    """Mean, median and 95th percentile ms a frame in each quarter of the
    window, for the log."""
    n = len(lat) // QUARTERS
    if not n:
        return "-"
    parts = []
    for q in range(QUARTERS):
        part = sorted(lat[q * n:(q + 1) * n])
        parts.append(f"{sum(part) / n * 1e3:.4f}/{part[n // 2] * 1e3:.4f}/"
                     f"{part[int(0.95 * (n - 1))] * 1e3:.4f}")
    return " ".join(parts)


def run(cell: drive.Cell) -> drive.Outcome:
    import splat_tpu_torch as stt

    dev, tr = cell.device, cell.traffic
    tile = cell.config["render"]["tile"]
    drive.log(f"start: {time.perf_counter() - cell.t_start:.3f} s")
    leaves = scenes.generate(cell.config["scene"], cell.seed, dev)
    scene = stt.GaussianScene.create(**leaves, device=dev)
    base = poses.base_pose(cell.config["camera"], dev)
    yaws, pitches = poses.orbit_path(tr, cell.seed, dev)
    period = yaws.numel()

    def pose(i):
        return dict(base, yaw=yaws[i % period], pitch=pitches[i % period])

    # render()'s capacity, sized at the path's heaviest pose before the
    # window, covers every pose of the path (10% headroom over the
    # sampled poses' largest load)
    drive.sync(dev)
    drive.log(f"scene: {time.perf_counter() - cell.t_start:.3f} s")
    packed = scene.pack_device()
    stride = int(tr["warm_stride"])
    loads = [stt.pair_stats(packed, stt.Camera(**pose(i)))["num_pairs"]
             for i in range(0, period, stride)]
    heavy = stride * max(range(len(loads)), key=loads.__getitem__)
    drive.log(f"loads: {time.perf_counter() - cell.t_start:.3f} s")
    stt.render(scene, stt.Camera(**pose(heavy)))
    for i in range(int(tr["warm_frames"])):
        stt.render(scene, stt.Camera(**pose(i)))
    drive.sync(dev)
    # the loop's first seconds run slower (2-15 s at about +8% on a 3 ms
    # frame on most machines, up to 40 s on some); ten pass in the set-up
    t_settle = time.perf_counter()
    i = 0
    while time.perf_counter() - t_settle < float(tr["settle_s"]):
        stt.render(scene, stt.Camera(**pose(i)))
        drive.sync(dev)
        i += 1
    drive.log(f"set-up: {len(loads)} poses measured, heaviest {max(loads)} "
              f"pairs at frame {heavy}")

    sample = Sample(int(tr["check_frames"]), cell.seed)
    lat, failed, frames = [], 0, 0

    def frame(i):
        nonlocal failed, frames
        t0 = time.perf_counter()
        try:
            img = stt.render(scene, stt.Camera(**pose(i)))
            drive.sync(dev)
        except Exception:           # a frame that raised counts as failed
            if not failed:
                traceback.print_exc()
            failed += 1
            img = None
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        sample.offer(i, img)
        frames += 1
        return t1

    drive.peak_reset(dev)
    summary, unit_s = None, None
    t_win = time.perf_counter()
    setup_s = t_win - cell.t_start
    if cell.traced:
        from torch.profiler import record_function
        n = int(tr["trace_frames"])
        passes = int(tr["untraced_passes"])
        for k in range(passes * n):
            now = frame(k % n)
        unit_s = (now - t_win) / (passes * n)
        events: dict = {}
        with trace.traced(events):
            for i in range(n):
                with record_function(FRAME_SPAN):
                    frame(i)
        summary = trace.summarize(events.pop("events"), n)
        window_s = summary["window_s"]
        drive.log(f"untraced {unit_s * 1e3:.4f} ms a frame over {passes} "
                  f"passes of the traced {n}")
    else:
        now = t_win
        while frames == 0 or now - t_win < cell.seconds:
            now = frame(frames)
        window_s = now - t_win
        drive.log(f"quarters, ms a frame (mean/p50/p95): {_quarters(lat)}")
    peak = drive.peak(dev)
    drive.log(f"window: {frames} frames in {window_s:.3f} s, {failed} failed")

    # the program's state goes before the reference runs
    del scene, packed
    drive.free(dev)
    pairs, works = [], []
    for i, img in sorted(sample.items, key=lambda x: x[0]):
        ref = reference.render(leaves, pose(i), tile, count=cell.traced)
        if cell.traced:
            ref, work = ref
            works.append(work)
        pairs.append((img, ref))
    numbers = check.frame_numbers(pairs)
    drive.log(f"check: {time.perf_counter() - cell.t_start:.3f} s")
    result = harness.Run(setup_s=setup_s, window_s=window_s, frames=frames,
                         latencies_s=lat, trace=summary, unit_s=unit_s,
                         frame_work=works or None,
                         pixels=base["h"] * base["w"])
    return drive.Outcome(
        run=result, attempted=frames, failed=failed, numbers=numbers,
        peak_bytes=peak,
        kept={"leaves": leaves,
              "poses": [pose(i) for i, _ in sorted(sample.items,
                                                   key=lambda x: x[0])],
              "reference": [ref for _, ref in pairs]})


def readings(cell: drive.Cell, out: drive.Outcome, control: bool) -> list:
    """The sound run's numbers, and with ``control`` the control's: the
    reference with its per-pair features in bfloat16 in the program's
    place, at the same poses."""
    rows = [dict(kind="sound", seed=cell.seed, **out.numbers)]
    if control:
        kept = out.kept
        tile = cell.config["render"]["tile"]
        pairs = [(reference.render(kept["leaves"], p, tile,
                                   feature_dtype=torch.bfloat16), ref)
                 for p, ref in zip(kept["poses"], kept["reference"])]
        rows.append(dict(kind="control_bf16", seed=cell.seed,
                         **check.frame_numbers(pairs)))
    return rows
