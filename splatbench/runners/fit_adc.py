"""The ``fit_adc`` kind: ``fit(method="tiled")`` on one card with the
configuration's adaptive density control (ADC, its ``densify`` block)
every ``interval`` steps.

The set-up makes the scene, the views and the targets as ``runners/fit.py``
does, then runs the checked call ``fit(steps=2 c, densify_every=c)`` (c =
``check_steps``): one round between c steps and c, whose inputs and output
``densify_cb`` hands over (they wait on the host through the window).  A
short call without rounds sizes the window: its one call, ``fit(
densify_every=interval)`` of K steps, K the least multiple of the interval
that fills ``--seconds`` (one interval at least, so a run at a given speed
always makes the same rounds), continues from the checked call's state.  A
traced run times ``trace_steps`` steps with a round every
``trace_densify_every`` untraced, then the same call under the profiler;
the slice's summary gains the wall seconds of the program's
``stt.fit.densify`` spans, their count and the device seconds inside them.

Only a truncated forward fails the window (fit's warning that footprints
grew past the capacity margin mid-segment); the re-audit's raise of the
capacity after a round is a normal part of a round, counted and logged.

The check, after the window, compares each part on the same inputs
(``reference/densify.py``):

* ``loss_gap``, ``change_gap``: the c steps before the round, as the fit
  cell compares its first steps;
* ``grad_gap``: the round's statistic, the program's against the
  reference's own, the norm of the gap over the reference's norm;
* ``round_gap``: the reference's round of the program's pre-round leaves
  and statistic against the program's round: inf where a count differs,
  else the worst leaf's largest gap over its largest magnitude;
* ``flip_excess``: live splats that the reference's own statistic would
  densify otherwise and whose reference value lies farther from the
  threshold than ``grad_gap``'s limit allows one statistic to move;
* ``loss_gap_after``, ``change_gap_after``: the c steps after the round,
  each side from the program's post-round leaves with a fresh Adam.
"""

from __future__ import annotations

import importlib.util
import inspect
import math
import pathlib
import time
import warnings

import torch

from splatbench import check, drive, harness, poses, scenes, trace
from splatbench.reference import densify as adc
from splatbench.reference import render as reference

_spec = importlib.util.spec_from_file_location(
    "splatbench_runners_fit_helpers",
    pathlib.Path(__file__).with_name("fit.py"))
FIT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(FIT)

DENSIFY_SPAN = "stt.fit.densify"
TRUNCATED = "fit: splat footprints grew past the capacity margin"
RAISED = "fit: densification left"
ROUND_KEYS = ("grad_threshold", "split_scale_threshold", "min_opacity",
              "split_factor", "pad_multiple", "max_gaussians", "seed")
COUNTERS = ("rounds", "device_rounds", "cloned", "split", "pruned")
NUMBERS = ("loss_gap", "change_gap", "grad_gap", "round_gap", "flip_excess",
           "loss_gap_after", "change_gap_after")


def classify(messages) -> tuple[list, list]:
    """(truncations, capacity raises) among fit's warning messages."""
    messages = list(messages)
    return ([m for m in messages if m.startswith(TRUNCATED)],
            [m for m in messages if m.startswith(RAISED)])


def window_steps(seconds: float, step_s: float, interval: int) -> int:
    """The least multiple of ``interval`` steps that fills ``seconds``,
    one interval at least."""
    return interval * max(1, math.ceil(seconds / step_s / interval))


def densify_spans(events: list) -> dict:
    """Wall seconds of the program's round spans inside the traced
    window, their count, and the device seconds inside them (the union
    of the device intervals that fall in a span)."""
    win = next(e for e in events if e.get("ph") == "X"
               and e.get("name") == trace.WINDOW_SPAN)
    t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("name") == DENSIFY_SPAN
                   and e.get("cat") == "user_annotation"
                   and t0 <= float(e["ts"]) < t1)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") in trace.DEVICE_CATS)
    busy = 0.0
    for a, b in spans:
        end = a
        for s, f in dev:
            s, f = max(s, end), min(f, b)
            if f > s:
                busy += f - s
                end = f
    return {"densify_s": sum(b - a for a, b in spans) * 1e-6,
            "densify_rounds": len(spans), "densify_busy_s": busy * 1e-6}


def counters() -> dict:
    from splat_tpu_torch import train

    return {k: getattr(train.densify_and_prune, k, 0) for k in COUNTERS}


def _leaves(raw, device) -> dict:
    return {k: getattr(raw, k).detach().to(device)
            for k in reference.RAW_LEAVES}


def run(cell: drive.Cell) -> drive.Outcome:
    import splat_tpu_torch as stt

    if "densify_cb" not in inspect.signature(stt.fit).parameters:
        raise RuntimeError("this program's fit() takes no densify_cb, so "
                           "the check cannot see a round's inputs")
    dev, tr = cell.device, cell.traffic
    block = cell.config["densify"]
    interval = int(block["interval"])
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
              l1_weight=tr["l1_weight"], dssim_weight=tr["dssim_weight"],
              densify_kwargs={k: block[k] for k in ROUND_KEYS})
    c = int(tr["check_steps"])
    rounds = []

    def keep_round(before, grad_mean, after, stats):
        # the round's inputs and output wait on the host: the window's
        # peak memory is the program's own
        rounds.append((_leaves(before, "cpu"), grad_mean.detach().cpu(),
                       _leaves(after, "cpu"), dict(stats)))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = stt.fit(scene0, cams, targets, steps=2 * c, densify_every=c,
                        densify_cb=keep_round, **kw)
        first_losses = first.losses.tolist()
        drive.sync(dev)
        drive.log(f"checked steps: {time.perf_counter() - cell.t_start:.3f}"
                  f" s, rounds {[r[3] for r in rounds]}")
        t0 = time.perf_counter()
        stt.fit(first.scene, cams, targets, steps=int(tr["timing_steps"]),
                **kw)
        drive.sync(dev)
        est = (time.perf_counter() - t0) / int(tr["timing_steps"])
        steps = window_steps(cell.seconds, est, interval)
        set_up = len(caught)
        before_win = counters()
        drive.peak_reset(dev)
        summary, unit_s = None, None
        t_win = time.perf_counter()
        setup_s = t_win - cell.t_start
        if cell.traced:
            from torch.profiler import record_function
            steps = int(tr["trace_steps"])
            every = int(tr["trace_densify_every"])
            stt.fit(first.scene, cams, targets, steps=steps,
                    densify_every=every, **kw)
            drive.sync(dev)
            unit_s = (time.perf_counter() - t_win) / steps
            events: dict = {}
            with trace.traced(events):
                with record_function(FIT.FIT_SPAN):
                    res = stt.fit(first.scene, cams, targets, steps=steps,
                                  densify_every=every, **kw)
            events = events.pop("events")
            summary = trace.summarize(events, steps)
            summary.update(densify_spans(events))
            window_s = summary["window_s"]
            drive.log(f"untraced {unit_s * 1e3:.3f} ms a step over the "
                      f"traced {steps}; rounds traced: "
                      f"{summary['densify_rounds']}, "
                      f"{summary['densify_s'] * 1e3:.3f} ms wall, "
                      f"{summary['densify_busy_s'] * 1e3:.3f} ms device")
        else:
            res = stt.fit(first.scene, cams, targets, steps=steps,
                          densify_every=interval, **kw)
            drive.sync(dev)
            window_s = time.perf_counter() - t_win
        peak = drive.peak(dev)
        truncated, raised = classify(str(w.message)
                                     for w in caught[set_up:])
    after_win = counters()
    bad = bool(truncated) or not bool(torch.isfinite(res.losses).all())
    failed = steps if bad else 0
    drive.log(f"window: {steps} steps in {window_s:.3f} s (estimated "
              f"{est * 1e3:.1f} ms a step), {len(truncated)} truncations, "
              f"{len(raised)} capacity raises after a round; rounds "
              f"{list(res.densify_log)}; counters "
              f"{ {k: after_win[k] - before_win[k] for k in COUNTERS} }")
    final = _leaves(first.raw, dev)
    del res, first, scene0, cams
    drive.free(dev)

    checked = check_round(cell, start, views, targets, first_losses, final,
                          rounds)
    drive.log(f"check: {time.perf_counter() - cell.t_start:.3f} s")
    result = harness.Run(setup_s=setup_s, window_s=window_s, steps=steps,
                         trace=summary, unit_s=unit_s,
                         view_work=checked["work"] if cell.traced else None,
                         pixels=views[0]["h"] * views[0]["w"], params=n * 59)
    return drive.Outcome(run=result, attempted=steps, failed=failed,
                         numbers=checked["numbers"], peak_bytes=peak,
                         kept=dict(checked, start=start, views=views,
                                   targets=targets, final=final))


def _recipes(cell):
    tr = cell.traffic
    loss = {"l1_weight": tr["l1_weight"], "dssim_weight": tr["dssim_weight"]}
    opt = {"lr": tr["lr"], "lr_scales": tr["lr_scales"]}
    return loss, opt, dict(cell.config["densify"])


def round_gap(prog: dict, prog_stats: dict, ref: dict,
              ref_stats: dict) -> float:
    """inf where a count differs; else the worst leaf's largest gap over
    its largest magnitude."""
    if prog_stats != ref_stats:
        return math.inf
    worst = 0.0
    for k in reference.RAW_LEAVES:
        p, r = prog[k].to(ref[k].device), ref[k]
        if p.shape != r.shape:
            return math.inf
        if r.numel():
            scale = max(float(r.abs().max()), 1e-30)
            worst = max(worst, float((p - r).abs().max()) / scale)
    return worst


def flip_excess(before: dict, g_prog, g_ref, block: dict,
                limit: float) -> tuple[int, list]:
    """(flips outside the band, each flip's distance from the threshold
    as a share of it): live splats whose decision to densify differs
    between the two statistics.  The band is what ``grad_gap``'s
    ``limit`` allows one statistic: ``limit`` x the norm of the
    reference's, as no single gap exceeds the norm of all of them.  (Sound
    runs put single statistics up to 0.76 x the threshold apart, so a
    band per splat would fail them.)"""
    thr = block["grad_threshold"]
    alive = adc.opacity(before["logit_opacities"]) > block["min_opacity"]
    flip = alive & ((g_prog > thr) != (g_ref > thr))
    dist = (g_ref[flip] - thr).abs()
    band = limit * float(torch.linalg.vector_norm(g_ref))
    return int((dist > band).sum()), (dist / thr).tolist()


def check_round(cell, start, views, targets, prog_losses, final,
                rounds) -> dict:
    """The check's numbers, and what the calibration's faults reuse."""
    dev, c = cell.device, int(cell.traffic["check_steps"])
    loss, opt, block = _recipes(cell)
    raw0 = reference.raw_from_scene(start)
    pre = adc.steps(raw0, views, targets, loss, c, work=cell.traced, **opt)
    if len(rounds) != 1 or len(prog_losses) != 2 * c:
        return {"numbers": dict.fromkeys(NUMBERS, math.inf),
                "work": pre["work"]}
    before, g_prog, after, stats = rounds[0]
    before = {k: v.to(dev) for k, v in before.items()}
    after = {k: v.to(dev) for k, v in after.items()}
    g_prog = g_prog.to(dev)
    numbers = check.fit_numbers(prog_losses[:c], pre["losses"], before,
                                pre["raw"], raw0, pre["gnorm"])
    numbers["grad_gap"] = float(torch.linalg.vector_norm(
        g_prog - pre["grad_mean"]) / torch.linalg.vector_norm(
        pre["grad_mean"]))
    ref_after, ref_stats, src = adc.densify(before, g_prog, block,
                                            seed=block["seed"])
    numbers["round_gap"] = round_gap(after, stats, ref_after, ref_stats)
    far, flips = flip_excess(before, g_prog, pre["grad_mean"], block,
                             cell.limits["limits"]["grad_gap"])
    numbers["flip_excess"] = float(far)
    thr = block["grad_threshold"]
    near = (pre["grad_mean"] - thr).abs() < 0.5 * thr
    rel = ((g_prog - pre["grad_mean"]).abs() / thr)[near]
    post = adc.steps(after, views, targets, loss, c, **opt)
    later = check.fit_numbers(prog_losses[c:], post["losses"], final,
                              post["raw"], after, post["gnorm"])
    numbers["loss_gap_after"] = later["loss_gap"]
    numbers["change_gap_after"] = later["change_gap"]
    drive.log(f"round: program {stats}, reference {ref_stats}; "
              f"{len(flips)} decisions flipped between the statistics, at "
              f"{[f'{d:.3g}' for d in flips[:20]]} of the threshold from "
              f"it, {far} outside the band; within half the threshold of "
              f"it, {int(near.sum())} statistics differ by up to "
              f"{float(rel.max()) if rel.numel() else 0.0:.3g} of it; "
              f"losses before {prog_losses[:c]} / "
              f"{pre['losses']}, after {prog_losses[c:]} / "
              f"{post['losses']}")
    return {"numbers": numbers, "work": pre["work"], "pre": pre,
            "post": post, "before": before, "g_prog": g_prog,
            "after": after, "stats": stats, "ref_after": ref_after,
            "ref_stats": ref_stats, "src": src}


def _without_clones(new: dict, stats: dict, multiple: int):
    """A round's output with its clone block left out, padded again."""
    a = stats["kept"]
    b = a + stats["cloned"]
    n = b + 2 * stats["split"]
    rows = {k: torch.cat([v[:a], v[b:n]]) for k, v in new.items()}
    rows, extra = adc.pad(rows, multiple)
    return rows, dict(stats, cloned=0, padded=extra,
                      n=rows["means"].shape[0])


def readings(cell: drive.Cell, out: drive.Outcome, control: bool) -> list:
    """The sound run's numbers, and with ``control`` those of the control
    (the reference with bfloat16 per-pair features in the program's place)
    and of the faults a run can have, each in the program's place: a round
    skipped, clones not made, split children left at full scale, split
    offsets from another seed, pruning skipped, Adam's moments kept
    through the round, and a state left unchanged.  A fault of the round
    that changes nothing in it (where nothing splits, say) is left out."""
    rows = [dict(kind="sound", seed=cell.seed, **out.numbers)]
    k = out.kept
    if not control or "pre" not in k:
        return rows
    loss, opt, block = _recipes(cell)
    c = int(cell.traffic["check_steps"])
    sound = out.numbers

    # the control: the steps on each side of the round with bfloat16
    # features, each from the start the program's steps took
    pre, post = k["pre"], k["post"]
    ctl_pre = adc.steps(reference.raw_from_scene(k["start"]), k["views"],
                        k["targets"], loss, c, feature_dtype=torch.bfloat16,
                        **opt)
    ctl_post = adc.steps(k["after"], k["views"], k["targets"], loss, c,
                         feature_dtype=torch.bfloat16, **opt)
    raw0 = reference.raw_from_scene(k["start"])
    control_row = check.fit_numbers(ctl_pre["losses"], pre["losses"],
                                    ctl_pre["raw"], pre["raw"], raw0,
                                    pre["gnorm"])
    control_row["grad_gap"] = float(torch.linalg.vector_norm(
        ctl_pre["grad_mean"] - pre["grad_mean"])
        / torch.linalg.vector_norm(pre["grad_mean"]))
    control_row["round_gap"] = sound["round_gap"]
    control_row["flip_excess"] = float(flip_excess(
        k["before"], ctl_pre["grad_mean"], pre["grad_mean"], block,
        cell.limits["limits"]["grad_gap"])[0])
    later = check.fit_numbers(ctl_post["losses"], post["losses"],
                              ctl_post["raw"], post["raw"], k["after"],
                              post["gnorm"])
    control_row["loss_gap_after"] = later["loss_gap"]
    control_row["change_gap_after"] = later["change_gap"]
    rows.append(dict(kind="control_bf16", seed=cell.seed, **control_row))

    def faulty_round(name, new, stats):
        gap = round_gap(new, stats, k["ref_after"], k["ref_stats"])
        if gap == 0.0:
            # the fault changes nothing in this round (nothing to split
            # or prune): no fault of this run
            drive.log(f"{name}: the round has nothing it changes")
            return
        rows.append(dict(kind=name, seed=cell.seed,
                         **dict(sound, round_gap=gap)))

    before, g = k["before"], k["g_prog"]
    faulty_round("fault_round_skipped", before,
                 dict(k["ref_stats"], n=before["means"].shape[0]))
    faulty_round("fault_no_clones", *_without_clones(
        k["ref_after"], k["ref_stats"], int(block["pad_multiple"])))
    for name, change in (("fault_full_scale", {"split_factor": 1.0}),
                         ("fault_other_seed", {"seed": block["seed"] + 1}),
                         ("fault_no_prune", {"min_opacity": -math.inf})):
        recipe = dict(block, **change)
        new, stats, _ = adc.densify(before, g, recipe, seed=recipe["seed"])
        faulty_round(name, new, stats)

    kept_adam = adc.carry_moments(pre["adam"], k["src"])
    moments = adc.steps(k["after"], k["views"], k["targets"], loss, c,
                        adam=kept_adam, **opt)
    later = check.fit_numbers(moments["losses"], post["losses"],
                              moments["raw"], post["raw"], k["after"],
                              post["gnorm"])
    rows.append(dict(kind="fault_moments_kept", seed=cell.seed,
                     **dict(sound, loss_gap_after=later["loss_gap"],
                            change_gap_after=later["change_gap"])))
    unchanged = check.fit_numbers([pre["losses"][0]] * c, pre["losses"],
                                  raw0, pre["raw"], raw0, pre["gnorm"])
    rows.append(dict(kind="fault_state_unchanged", seed=cell.seed,
                     **dict(sound, **unchanged)))
    return rows
