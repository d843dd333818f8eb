"""The adaptive density control cell on the CPU at a tiny size (2,000
gaussians, 48 x 64, a round every 2 steps): the port's fit against the
plain reference's (``reference/densify.py``), the reference's round
against the port's NumPy twin, the runner's rule for fit's warnings, a
sound run correct, and each fault of a round, in the program's place and
in the calibration's readings, not correct."""

import functools
import warnings

import numpy as np
import pytest
import torch

import splat_tpu_torch as stt
from splat_tpu_torch import train as tt
from splatbench import check, harness, poses, scenes
from splatbench.reference import densify as adc
from splatbench.reference import render as reference

from helpers import BENCH, run, small_cell

WORKLOAD = "surface-3m-fit-adc"
RUNNER = BENCH.runner("fit_adc")
# a threshold that clones and splits a few percent of the tiny cell; an
# opacity floor that prunes some of the surface law's splats
TINY = {"interval": 2, "grad_threshold": 1e-5, "min_opacity": 0.3}


def _cell(seed=2**31 + 19):
    cell = small_cell(WORKLOAD, seconds=0.2, seed=seed, check_steps=2,
                      timing_steps=1, trace_steps=4, trace_densify_every=2)
    cell.config["scene"]["n"] = 2000
    cell.config["camera"].update(h=48, w=64)
    cell.config["densify"].update(TINY)
    return cell


def _verdict(cell, out):
    return check.judge(out.numbers, cell.limits["limits"])[0]


@pytest.fixture(scope="module")
def sound():
    cell = _cell()
    return cell, run(cell)


def test_sound_run_is_correct(sound):
    cell, out = sound
    assert _verdict(cell, out) and out.failed == 0
    stats = out.kept["stats"]
    assert min(stats["cloned"], stats["split"], stats["pruned"],
               stats["padded"]) > 0, stats
    assert out.numbers["flip_excess"] == 0


def test_port_fit_matches_reference_fit():
    """fit(steps=4, densify_every=2, method="tiled") against the
    reference's loop on the same start: losses, the round's counts, and
    the round the program reports equal to the reference's round of the
    same inputs."""
    cell = _cell(seed=2**31 + 23)
    cfg, tr = cell.config, cell.traffic
    truth = scenes.generate(cfg["scene"], cell.seed, "cpu")
    views = poses.fit_views(tr, poses.base_pose(cfg["camera"], "cpu"))
    targets = torch.stack([reference.render(truth, p, 32) for p in views])
    start = dict(truth, sh=truth["sh"] * 0.8)
    block = dict(cfg["densify"])
    kw = {k: block[k] for k in RUNNER.ROUND_KEYS}
    calls = []
    res = stt.fit(stt.GaussianScene.create(**start, device="cpu"),
                  [stt.Camera(**p) for p in views], targets, steps=4,
                  lr=tr["lr"], lr_scales=dict(tr["lr_scales"]),
                  method="tiled", l1_weight=0.2, dssim_weight=0.2,
                  densify_every=2, densify_kwargs=kw,
                  densify_cb=lambda *a: calls.append(a))
    loss = {"l1_weight": 0.2, "dssim_weight": 0.2}
    ref = adc.fit(reference.raw_from_scene(start), views, targets, loss,
                  block, total=4, interval=2, lr=tr["lr"],
                  lr_scales=tr["lr_scales"])
    assert len(calls) == 1 and ref["log"] == list(res.densify_log)
    s = ref["log"][0]
    assert min(s["cloned"], s["split"], s["pruned"], s["padded"]) > 0, s
    for p, r in zip(res.losses.tolist(), ref["losses"]):
        assert abs(p - r) / r < 1e-4
    before, g, after, stats = calls[0]
    leaves = {k: getattr(before, k) for k in reference.RAW_LEAVES}
    new, ref_stats, src = adc.densify(leaves, g, block, seed=block["seed"])
    got = {k: getattr(after, k) for k in reference.RAW_LEAVES}
    assert RUNNER.round_gap(got, stats, new, ref_stats) < 1e-6
    assert int((src < 0).sum()) == stats["padded"]
    for k in reference.RAW_LEAVES:
        a = getattr(res.raw, k)
        assert a.shape == ref["raw"][k].shape
        gap = float(torch.linalg.vector_norm(a - ref["raw"][k]))
        assert gap <= 1e-3 * float(torch.linalg.vector_norm(ref["raw"][k]))


@pytest.mark.parametrize("kw", [
    dict(grad_threshold=2e-4),
    dict(grad_threshold=1e-4, split_scale_threshold=0.05, min_opacity=0.3,
         split_factor=2.0, pad_multiple=64, seed=3),
], ids=["default", "given_threshold"])
def test_reference_round_matches_twin(kw):
    d = stt.random_scene(1500, seed=9, extent=1.5, scale_range=(0.005, 0.08),
                         device="cpu").to_numpy()
    op = np.clip(d["opacities"], 1e-4, 1 - 1e-4)
    raw = {"means": torch.tensor(d["means"]),
           "quats": torch.tensor(d["quats"] * np.float32(1.3)),
           "log_scales": torch.log(torch.tensor(d["scales"])),
           "logit_opacities": torch.tensor(np.log(op) - np.log1p(-op)),
           "sh": torch.tensor(d["sh"])}
    g = torch.tensor(np.random.default_rng(4).exponential(1e-4, 1500)
                     .astype(np.float32))
    recipe = dict({"split_scale_threshold": None, "min_opacity": 0.005,
                   "split_factor": 1.6, "pad_multiple": 256, "seed": 0}, **kw)
    new, stats, _ = adc.densify(raw, g, recipe, seed=recipe["seed"])
    twin, tstats = tt.densify_and_prune_plain(tt.RawParams(**raw), g, **kw)
    assert stats == tstats and stats["cloned"] > 0 and stats["split"] > 0
    got = {k: getattr(twin, k) for k in reference.RAW_LEAVES}
    assert RUNNER.round_gap(got, tstats, new, stats) < 1e-6


def test_warnings_rule():
    """A capacity raise after a round is part of a round; a truncated
    forward fails the window."""
    raised = ("fit: densification left max_dup_factor=4.0 below the "
              "measured pair demand (4.20); raising it to 4.25")
    cut = ("fit: splat footprints grew past the capacity margin mid-"
           "segment (peak demand 9 pairs > k_cap 8); ...")
    assert RUNNER.classify([raised, "other"]) == ([], [raised])
    assert RUNNER.classify([cut, raised]) == ([cut], [raised])


def _warning_in_window(message):
    real = stt.fit

    @functools.wraps(real)
    def fit(scene, cameras, targets, **kw):
        res = real(scene, cameras, targets, **kw)
        if kw.get("densify_cb") is None and kw.get("densify_every"):
            warnings.warn(message)
        return res
    return fit


@pytest.mark.parametrize("message, ok", [
    ("fit: densification left max_dup_factor=4.0 below the measured pair "
     "demand (4.20); raising it to 4.25", True),
    ("fit: splat footprints grew past the capacity margin mid-segment "
     "(peak demand 9 pairs > k_cap 8)", False),
], ids=["capacity_raised", "truncated"])
def test_window_warning_verdict(monkeypatch, message, ok):
    monkeypatch.setattr(stt, "fit", _warning_in_window(message))
    cell = _cell()
    out = run(cell)
    assert (out.failed == 0) == ok
    assert (_verdict(cell, out) and out.failed == 0) == ok


# -- faults of the program's round -----------------------------------------
# (a wrapper of densify_and_prune carries its counters: the function
# counts its rounds on whatever its module's name now holds)

def _round_skipped(monkeypatch):
    real = stt.fit
    monkeypatch.setattr(stt, "fit", functools.wraps(real)(
        lambda *a, **kw: real(*a, **dict(kw, densify_every=0))))


def _with(change):
    def fault(monkeypatch):
        real = tt.densify_and_prune
        monkeypatch.setattr(tt, "densify_and_prune", functools.wraps(real)(
            lambda raw, g, **kw: real(raw, g, **dict(kw, **change(kw)))))
    return fault


def _no_clones(monkeypatch):
    real = tt.densify_and_prune

    @functools.wraps(real)
    def densify(raw, g, **kw):
        new, stats = real(raw, g, **kw)
        leaves = {k: getattr(new, k) for k in reference.RAW_LEAVES}
        rows, stats = RUNNER._without_clones(leaves, stats,
                                             kw["pad_multiple"])
        return tt.RawParams(**rows), stats
    monkeypatch.setattr(tt, "densify_and_prune", densify)


def _moments_kept(monkeypatch):
    """Adam's moments and count carried through the round to the rows
    they came from (INRIA's way)."""
    real, real_adam = tt.densify_and_prune, tt._Adam
    seen = {}

    @functools.wraps(real)
    def densify(raw, g, **kw):
        leaves = {k: getattr(raw, k) for k in reference.RAW_LEAVES}
        seen["src"] = adc.densify(leaves, g, kw, seed=kw["seed"])[2]
        return real(raw, g, **kw)

    class KeptAdam(real_adam):
        def __init__(self, raw):
            super().__init__(raw)
            last, src = seen.get("adam"), seen.pop("src", None)
            if last is not None and src is not None:
                live, at = src >= 0, src.clamp(min=0)
                for k, st in self.state.items():
                    old = last.state[k]
                    mask = live.reshape((-1,) + (1,) * (st[1].dim() - 1))
                    self.state[k] = [old[0],
                                     torch.where(mask, old[1][at], 0.0),
                                     torch.where(mask, old[2][at], 0.0)]
            seen["adam"] = self
    monkeypatch.setattr(tt, "densify_and_prune", densify)
    monkeypatch.setattr(tt, "_Adam", KeptAdam)


FAULTS = {
    "round_skipped": _round_skipped,
    "no_clones": _no_clones,
    "full_scale": _with(lambda kw: {"split_factor": 1.0}),
    "other_seed": _with(lambda kw: {"seed": kw["seed"] + 1}),
    "no_prune": _with(lambda kw: {"min_opacity": -1.0}),
    "moments_kept": _moments_kept,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    cell = _cell()
    assert not _verdict(cell, run(cell))


def test_calibration_readings_fail(sound):
    """The control and every fault of the readings, in the program's
    place, fail the cell's limits; the sound reading passes."""
    cell, out = sound
    rows = RUNNER.readings(cell, out, True)
    limits = cell.limits["limits"]
    verdicts = {r["kind"]: check.judge({k: r[k] for k in limits}, limits)[0]
                for r in rows}
    assert verdicts.pop("sound")
    assert set(verdicts) == {
        "control_bf16", "fault_round_skipped", "fault_no_clones",
        "fault_full_scale", "fault_other_seed", "fault_no_prune",
        "fault_moments_kept", "fault_state_unchanged"}
    assert not any(verdicts.values()), verdicts


def test_readings_leave_out_faults_that_change_nothing():
    """Where nothing splits (as in the full-size cell), split children at
    full scale and offsets from another seed are the sound round: the
    readings leave them out, and every reading left fails."""
    cell = _cell()
    cell.config["densify"]["split_scale_threshold"] = 10.0
    out = run(cell)
    assert out.kept["stats"]["split"] == 0
    rows = RUNNER.readings(cell, out, True)
    limits = cell.limits["limits"]
    verdicts = {r["kind"]: check.judge({k: r[k] for k in limits}, limits)[0]
                for r in rows}
    assert verdicts.pop("sound")
    assert "fault_full_scale" not in verdicts
    assert "fault_other_seed" not in verdicts
    assert "fault_no_clones" in verdicts
    assert not any(verdicts.values()), verdicts


def test_traced_run_reads_the_round_span():
    cell = _cell()
    cell.traffic["trace_steps"] = 3
    cell.traced = True
    r = run(cell).run
    assert r.trace["densify_rounds"] == 1 and r.trace["densify_s"] > 0
    got = harness.read_metrics(BENCH, WORKLOAD, True, r)
    assert got["densify_ms.round"]["value"] == pytest.approx(
        r.trace["densify_s"] * 1e3)


def test_metric_is_silent_without_the_span():
    """A traced run of a program without the round's span reads
    nothing, and raises nothing."""
    reader = BENCH.reader("densify_ms.round")
    assert reader(harness.Run()) is None
    assert reader(harness.Run(trace={"densify_rounds": 0,
                                     "densify_s": 0.0})) is None
