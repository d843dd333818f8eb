"""Adaptive density control's two paths on the CPU: the on-device round
(``train._densify_on_device``, which ``densify_and_prune`` takes for CUDA
leaves) held to the NumPy twin on seeded states, the round's counters, and
``fit``'s span and ``densify_cb``.  Torch only; tiny states."""

import numpy as np
import pytest
import torch

import splat_tpu_torch as stt
from splat_tpu_torch import train as tt

torch.set_num_threads(1)

RAW = tt.RAW_FIELDS
COUNTERS = ("rounds", "device_rounds", "cloned", "split", "pruned")


def _state(n=1500, seed=0):
    """Raw leaves of a random cloud with some dead splats, and a
    grad_mean with a heavy tail."""
    d = stt.random_scene(n, seed=seed, extent=1.5, scale_range=(0.005, 0.08),
                         device="cpu").to_numpy()
    rng = np.random.default_rng(seed + 1)
    op = np.clip(d["opacities"], 1e-4, 1 - 1e-4).astype(np.float32)
    op[rng.random(n) < 0.05] = np.float32(0.002)
    raw = {"means": d["means"], "quats": d["quats"] * np.float32(1.7),
           "log_scales": np.log(d["scales"]),
           "logit_opacities": np.log(op) - np.log1p(-op), "sh": d["sh"]}
    g = rng.exponential(1e-4, n).astype(np.float32)
    return tt.RawParams.from_numpy(raw, device="cpu"), torch.tensor(g)


def assert_round_equal(dev_new, dev_stats, plain_new, plain_stats, bound):
    """Counts equal, every copied row bit for bit, split children's
    log-scales bit for bit, and their means apart by no more than an ulp
    of the mean and the float32 rounding of ``exp`` in the offset
    (``bound``: each child's sum of |s_j e_j|)."""
    assert dev_stats == plain_stats
    s = dev_stats
    lo = s["kept"] + s["cloned"]
    hi = lo + 2 * s["split"]
    for k in RAW:
        a = getattr(dev_new, k).cpu().numpy()
        b = getattr(plain_new, k).cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, k
        if k == "means":
            np.testing.assert_array_equal(a[:lo], b[:lo])
            np.testing.assert_array_equal(a[hi:], b[hi:])
            gap = np.abs(a[lo:hi] - b[lo:hi])
            assert (gap <= np.spacing(np.abs(b[lo:hi]))
                    + 2.0 ** -20 * bound).all()
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _check(raw, g, device=None, **kw):
    """The on-device round of ``raw`` against the twin's: on the CPU
    ``_densify_on_device`` itself, on a card ``densify_and_prune``, which
    must take it there.  Returns the round's counts."""
    full = dict(split_scale_threshold=None, min_opacity=0.005,
                split_factor=1.6, pad_multiple=256, seed=0)
    full.update(kw)
    if device is None:
        new, stats = tt._densify_on_device(raw, g, **full)
    else:
        on = tt.RawParams(**{k: getattr(raw, k).to(device) for k in RAW})
        rounds = tt.densify_and_prune.device_rounds
        new, stats = tt.densify_and_prune(on, g.to(device), **kw)
        assert tt.densify_and_prune.device_rounds == rounds + 1
        assert new.means.device == on.means.device
    plain, pstats = tt.densify_and_prune_plain(raw, g, **kw)
    assert_round_equal(new, stats, plain, pstats,
                       split_bound(raw, g, pstats, **kw))
    return stats


def split_bound(raw, g, stats, *, grad_threshold, min_opacity=0.005,
                split_scale_threshold=None, seed=0, **_):
    """Each split child's sum of |s_j e_j| over its offset's terms, from
    the twin's own scales, decisions and draws ((2 S, 1); 0 without
    splits): what bounds the float32 rounding of ``exp`` in its mean."""
    if not stats["split"]:
        return 0.0
    d = raw.to_numpy()
    sc = np.exp(d["log_scales"])
    opac = 1.0 / (1.0 + np.exp(-d["logit_opacities"]))
    needs = (opac > min_opacity) & (g.cpu().numpy() > grad_threshold)
    thr = split_scale_threshold
    if thr is None:
        live = d["means"][opac > min_opacity]
        thr = 0.01 * max(float(np.linalg.norm(live.max(0) - live.min(0))),
                         1e-6)
    split = np.flatnonzero(needs & (sc.max(1) > thr))
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.abs(sc[split] * rng.normal(size=(len(split), 3)).astype(
            np.float32)).sum(1) for _ in range(2)])[:, None]


@pytest.mark.parametrize("kw", [
    dict(grad_threshold=2e-4),
    dict(grad_threshold=1e-4, split_scale_threshold=0.03, pad_multiple=64,
         seed=11),
    dict(grad_threshold=5e-5, min_opacity=0.3, split_factor=2.0,
         pad_multiple=1, seed=5),
    dict(grad_threshold=10.0),
], ids=["default", "given_threshold", "prune_heavy", "no_split"])
def test_device_round_equals_twin(kw):
    stats = _check(*_state(), **kw)
    if kw["grad_threshold"] < 1.0:
        assert stats["cloned"] > 0 and stats["split"] > 0
        assert stats["pruned"] > 0


def test_device_round_decides_at_the_threshold_as_the_twin():
    """Gradients exactly at the float32 threshold and one ulp above it:
    the float32 comparison the twin makes."""
    raw, g = _state(n=600, seed=3)
    g[:200] = float(np.float32(2e-4))
    g[200:260] = float(np.nextafter(np.float32(2e-4), np.float32(1)))
    stats = _check(raw, g, grad_threshold=2e-4, split_scale_threshold=1.0)
    assert stats["cloned"] >= 60


def test_device_round_without_live_splats_takes_every_mean():
    raw, g = _state(n=300, seed=4)
    raw = tt.RawParams(raw.means, raw.quats, raw.log_scales,
                       torch.full_like(raw.logit_opacities, -20.0), raw.sh)
    stats = _check(raw, g, grad_threshold=1e-4, pad_multiple=8)
    assert stats["pruned"] == 300 and stats["n"] == 0


def test_counters_sum_the_rounds():
    raw, g = _state()
    before = {k: getattr(tt.densify_and_prune, k) for k in COUNTERS}
    _, s1 = tt.densify_and_prune(raw, g, grad_threshold=2e-4)
    _, s2 = tt.densify_and_prune(raw, g, grad_threshold=1e-4,
                                 max_gaussians=1400)
    got = {k: getattr(tt.densify_and_prune, k) - before[k] for k in COUNTERS}
    # CPU leaves take the NumPy twin
    assert got == {"rounds": 2, "device_rounds": 0,
                   "cloned": s1["cloned"] + s2["cloned"],
                   "split": s1["split"] + s2["split"],
                   "pruned": s1["pruned"] + s2["pruned"]}


@pytest.fixture(scope="module")
def tiny_fit():
    """fit(steps=4, densify_every=2) of a 1,000-splat cloud to two 48 x 64
    views, with every densify_cb call and every profiler span it opens
    kept (``torch.profiler.record_function`` recorded, not profiled)."""
    truth = stt.random_scene(1000, seed=2, extent=1.2,
                             scale_range=(0.01, 0.08), device="cpu")
    cams = stt.orbit_trajectory(
        stt.Camera.create(h=48, w=64, position=(0.0, 0.0, 4.0),
                          device="cpu"), 2, yaw_sweep=0.3)
    targets = torch.stack([stt.render_tiled(truth, c) for c in cams])
    d = truth.to_numpy()
    d["sh"] = d["sh"] * np.float32(0.7)
    start = stt.GaussianScene.from_numpy(d, device="cpu")
    calls, spans = [], []
    real = torch.profiler.record_function

    def record(name, *a, **k):
        spans.append(name)
        return real(name, *a, **k)

    before = {k: getattr(tt.densify_and_prune, k) for k in COUNTERS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", record)
        res = stt.fit(start, cams, targets, steps=4, method="tiled",
                      dssim_weight=0.2, densify_every=2,
                      densify_kwargs=dict(grad_threshold=2e-5,
                                          min_opacity=0.05, pad_multiple=64),
                      densify_cb=lambda *a: calls.append(a))
    counted = {k: getattr(tt.densify_and_prune, k) - before[k]
               for k in COUNTERS}
    return {"res": res, "calls": calls, "counted": counted, "spans": spans}


def test_fit_calls_densify_cb_once_a_round(tiny_fit):
    res, calls = tiny_fit["res"], tiny_fit["calls"]
    assert len(calls) == 1 and len(res.densify_log) == 1
    before, grad_mean, after, stats = calls[0]
    assert stats == res.densify_log[0]
    assert stats["cloned"] > 0 and stats["split"] > 0 and stats["pruned"] > 0
    assert before.num_gaussians == 1000 == grad_mean.shape[0]
    assert after.num_gaussians == stats["n"] == res.raw.num_gaussians
    # the round the callback reports is the round of its inputs
    again, again_stats = tt.densify_and_prune_plain(
        before, grad_mean, grad_threshold=2e-5, min_opacity=0.05,
        pad_multiple=64)
    assert again_stats == stats
    for k in RAW:
        assert torch.equal(getattr(again, k), getattr(after, k)), k
    assert torch.isfinite(res.losses).all() and res.losses.numel() == 4


def test_fit_counts_and_spans_each_round(tiny_fit):
    c = tiny_fit["counted"]
    stats = tiny_fit["res"].densify_log[0]
    assert c == {"rounds": 1, "device_rounds": 0, "cloned": stats["cloned"],
                 "split": stats["split"], "pruned": stats["pruned"]}
    assert tiny_fit["spans"].count("stt.fit.densify") == 1
