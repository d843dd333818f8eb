"""A run with the timed path broken underneath comes out not correct,
once for each fault the cells can have; a sound run comes out correct.
The runners run on the CPU at a small size (the look for a card skipped),
against the cells' own limits.  The control, the reference computed with
bfloat16 features in the program's place, fails them too, and so do the
calibration's faults in the reference's place."""

import dataclasses

import pytest

import splat_tpu_torch as stt
from splatbench import check

from helpers import BENCH, run, small_cell


def _verdict(out, cell):
    return check.judge(out.numbers, cell.limits["limits"])[0]


def _orbit(monkeypatch, workload, broken=None):
    if broken is not None:
        real = stt.render
        monkeypatch.setattr(stt, "render", broken(real))
    # a coarse path, so that a frame one pose stale differs at 64 x 96
    cell = small_cell(workload, seconds=3.0, frames_per_turn=40,
                      pitch_period=20)
    return _verdict(run(cell), cell)


def _stale(real):
    first = {}

    def render(scene, camera, *a, **k):
        img = real(scene, camera, *a, **k)
        return first.setdefault("img", img)
    return render


def _altered(real):
    def render(scene, camera, *a, **k):
        img = real(scene, camera, *a, **k).clone()
        img[:8, :8] += 0.05
        return img
    return render


def _half_scene(real):
    def render(scene, camera, *a, **k):
        return real(scene.slice(0, scene.num_gaussians // 2), camera, *a,
                    **k)
    return render


@pytest.mark.parametrize("workload", ["surface-3m-orbit", "random-1m-orbit"])
def test_orbit_sound_run_is_correct(monkeypatch, workload):
    assert _orbit(monkeypatch, workload)


@pytest.mark.parametrize("workload", ["surface-3m-orbit", "random-1m-orbit"])
@pytest.mark.parametrize("fault", [_stale, _altered, _half_scene],
                         ids=["state_unchanged", "answer_altered",
                              "half_left_out"])
def test_orbit_fault_is_caught(monkeypatch, workload, fault):
    assert not _orbit(monkeypatch, workload, fault)


def _fit(monkeypatch, broken=None):
    if broken is not None:
        monkeypatch.setattr(stt, "fit", broken(stt.fit))
    cell = small_cell("surface-3m-fit")
    return _verdict(run(cell), cell)


def _unchanged(real):
    def fit(scene, cameras, targets, **kw):
        res = real(scene, cameras, targets, **kw)
        return dataclasses.replace(
            res, scene=scene, raw=stt.RawParams.from_scene(scene))
    return fit


def _half_views(real):
    def fit(scene, cameras, targets, **kw):
        h = len(cameras) // 2
        return real(scene, cameras[:h], targets[:h], **kw)
    return fit


def _loss_altered(real):
    def fit(scene, cameras, targets, **kw):
        res = real(scene, cameras, targets, **kw)
        return dataclasses.replace(res, losses=res.losses * 1.01)
    return fit


def test_fit_sound_run_is_correct(monkeypatch):
    assert _fit(monkeypatch)


@pytest.mark.parametrize("fault", [_unchanged, _half_views, _loss_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_fit_fault_is_caught(monkeypatch, fault):
    assert not _fit(monkeypatch, fault)


@pytest.mark.parametrize("workload", ["surface-3m-orbit", "random-1m-orbit"])
def test_orbit_control_fails(workload):
    cell = small_cell(workload)
    rows = BENCH.runner("orbit").readings(cell, run(cell), True)
    control = next(r for r in rows if r["kind"] == "control_bf16")
    limits = cell.limits["limits"]
    assert not check.judge({k: control[k] for k in limits}, limits)[0]


def test_fit_control_fails():
    cell = small_cell("surface-3m-fit")
    rows = BENCH.runner("fit").readings(cell, run(cell), True)
    limits = cell.limits["limits"]
    verdicts = {r["kind"]: check.judge({k: r[k] for k in limits}, limits)[0]
                for r in rows}
    assert verdicts.pop("sound")
    assert not any(verdicts.values()), verdicts


@pytest.mark.parametrize("workload", ["random-1m-orbit", "surface-3m-fit"])
def test_traced_run_reads_its_shares_over_untraced_time(workload):
    """A traced run times the traced slice's work untraced as well, and
    the shares that divide by a frame's or a step's time read that time,
    not the profiled slice's wall."""
    from splatbench import harness, trace

    cell = small_cell(workload)
    cell.traced = True
    out = run(cell)
    r = out.run
    assert r.trace["units"] == 2 and r.unit_s > 0
    assert r.trace["window_s"] > 0 and out.numbers
    share = trace.idle_share(r)
    assert share == pytest.approx(
        100.0 * (1 - r.trace["busy_s"] / r.trace["units"] / r.unit_s))
    got = harness.read_metrics(BENCH, workload, True, r)
    assert set(got) <= {m["name"] for m in BENCH.metrics(workload, True)}
    assert ("idle_share.frame" if r.frames else "idle_share.step") in got
