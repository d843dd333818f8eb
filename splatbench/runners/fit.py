"""The ``fit`` kind: ``fit(method="tiled")`` on the mix's views, on one
card.

The set-up runs the checked first steps (a call of ``check_steps``),
times a short call to size the window, and hands the state the first
steps left to the window's one call.  A traced run times one untraced
call of ``trace_steps`` from that state on the host clock, then the same
call under the profiler: the per-layer shares divide by the untraced
time.  The reference follows the first steps from the same start.
"""

from __future__ import annotations

import math
import time
import warnings

import torch

from splatbench import check, drive, harness, poses, scenes, trace
from splatbench.reference import render as reference

FIT_SPAN = "splatbench.fit"


def run(cell: drive.Cell) -> drive.Outcome:
    import splat_tpu_torch as stt

    dev, tr = cell.device, cell.traffic
    tile = cell.config["render"]["tile"]
    truth = scenes.generate(cell.config["scene"], cell.seed, dev)
    views = poses.fit_views(tr, poses.base_pose(cell.config["camera"], dev))
    targets = torch.stack([reference.render(truth, p, tile) for p in views])
    start = dict(truth, sh=truth["sh"] * tr["sh_start_scale"])
    n = truth["means"].shape[0]
    del truth
    drive.free(dev)

    drive.log(f"targets: {time.perf_counter() - cell.t_start:.3f} s")
    scene0 = stt.GaussianScene.create(**start, device=dev)
    cams = [stt.Camera(**p) for p in views]
    kw = dict(lr=tr["lr"], lr_scales=dict(tr["lr_scales"]), method="tiled",
              l1_weight=tr["l1_weight"], dssim_weight=tr["dssim_weight"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = stt.fit(scene0, cams, targets, steps=int(tr["check_steps"]),
                        **kw)
        first_losses = first.losses.tolist()
        drive.sync(dev)
        drive.log(f"first steps: {time.perf_counter() - cell.t_start:.3f} s")
        t0 = time.perf_counter()
        stt.fit(first.scene, cams, targets, steps=int(tr["timing_steps"]),
                **kw)
        drive.sync(dev)
        est = (time.perf_counter() - t0) / int(tr["timing_steps"])
        steps = max(1, math.ceil(cell.seconds / est))
        set_up = len(caught)
        drive.peak_reset(dev)
        summary, unit_s = None, None
        t_win = time.perf_counter()
        setup_s = t_win - cell.t_start
        if cell.traced:
            from torch.profiler import record_function
            steps = int(tr["trace_steps"])
            stt.fit(first.scene, cams, targets, steps=steps, **kw)
            drive.sync(dev)
            unit_s = (time.perf_counter() - t_win) / steps
            events: dict = {}
            with trace.traced(events):
                with record_function(FIT_SPAN):
                    res = stt.fit(first.scene, cams, targets, steps=steps,
                                  **kw)
            summary = trace.summarize(events.pop("events"), steps)
            window_s = summary["window_s"]
            drive.log(f"untraced {unit_s * 1e3:.3f} ms a step over the "
                      f"traced {steps}")
        else:
            res = stt.fit(first.scene, cams, targets, steps=steps, **kw)
            drive.sync(dev)
            window_s = time.perf_counter() - t_win
        peak = drive.peak(dev)
        truncated = [str(w.message) for w in caught[set_up:]
                     if str(w.message).startswith("fit:")]
    bad = bool(truncated) or not bool(torch.isfinite(res.losses).all())
    failed = steps if bad else 0
    drive.log(f"window: {steps} steps in {window_s:.3f} s (estimated "
              f"{est * 1e3:.1f} ms a step), {len(truncated)} truncations")
    prog_raw = {k: getattr(first.raw, k).detach()
                for k in reference.RAW_LEAVES}
    del res, first, scene0, cams
    drive.free(dev)

    ref = reference_steps(cell, start, views, targets)
    numbers = check.fit_numbers(first_losses, ref["losses"], prog_raw,
                                ref["raw"], ref["raw0"], ref["gnorm"])
    drive.log(f"losses: program {first_losses}, reference {ref['losses']}; "
              f"check: {time.perf_counter() - cell.t_start:.3f} s")
    result = harness.Run(setup_s=setup_s, window_s=window_s, steps=steps,
                         trace=summary, unit_s=unit_s,
                         view_work=ref["work"] if cell.traced else None,
                         pixels=views[0]["h"] * views[0]["w"], params=n * 59)
    return drive.Outcome(run=result, attempted=steps, failed=failed,
                         numbers=numbers, peak_bytes=peak,
                         kept={"start": start, "views": views,
                               "targets": targets, "reference": ref})


def reference_steps(cell: drive.Cell, start: dict, views, targets, *,
                    feature_dtype=None, half: bool = False) -> dict:
    """The reference's first ``check_steps`` steps from ``start``:
    losses, the raw leaves after them, the start's raw leaves, each
    leaf's gradient norm at the first step and the first forward's work.

    ``feature_dtype`` and ``half`` (half of the views left out, the mean
    taken over the rest) put the control and a fault of the calibration
    in the program's place."""
    tr = cell.traffic
    recipe = {"l1_weight": tr["l1_weight"],
              "dssim_weight": tr["dssim_weight"]}
    raw0 = reference.raw_from_scene(start)
    raw, adam = raw0, reference.Adam(raw0, tr["lr"], tr["lr_scales"])
    losses, gnorm, work = [], None, None
    if half:
        views, targets = views[:len(views) // 2], targets[:len(views) // 2]
    for s in range(int(tr["check_steps"])):
        loss, grads, w = reference.loss_and_grads(
            raw, views, targets, recipe, feature_dtype=feature_dtype,
            count=cell.traced and s == 0)
        if s == 0:
            gnorm = {k: float(torch.linalg.vector_norm(g))
                     for k, g in grads.items()}
            work = w
        losses.append(float(loss))
        raw = adam.step(raw, grads)
    return {"losses": losses, "raw": raw, "raw0": raw0, "gnorm": gnorm,
            "work": work}


def readings(cell: drive.Cell, out: drive.Outcome, control: bool) -> list:
    """The sound run's numbers, and with ``control`` those of the control
    (the reference with bfloat16 per-pair features) and of the faults a
    run can have, each in the program's place against the reference:
    half of the views left out, and a state left unchanged."""
    rows = [dict(kind="sound", seed=cell.seed, **out.numbers)]
    if not control:
        return rows
    k = out.kept
    ref = k["reference"]

    def against(r):
        return check.fit_numbers(r["losses"], ref["losses"], r["raw"],
                                 ref["raw"], ref["raw0"], ref["gnorm"])

    variants = {"control_bf16": dict(feature_dtype=torch.bfloat16),
                "fault_half_batch": dict(half=True)}
    for name, kw in variants.items():
        rows.append(dict(kind=name, seed=cell.seed, **against(
            reference_steps(cell, k["start"], k["views"], k["targets"],
                            **kw))))
    unchanged = check.fit_numbers([ref["losses"][0]] * len(ref["losses"]),
                                  ref["losses"], ref["raw0"], ref["raw"],
                                  ref["raw0"], ref["gnorm"])
    rows.append(dict(kind="fault_state_unchanged", seed=cell.seed,
                     **unchanged))
    return rows
