"""The configurations' scene blocks are what the generators read, one
seed gives the same scene twice, and the laws are those of the port's
fixtures."""

import numpy as np
import pytest
import torch

import splat_tpu_torch as stt
from splatbench import scenes

from helpers import BENCH

CONFIGS = ["surface-3m", "random-1m"]


@pytest.mark.parametrize("name", CONFIGS)
def test_block_is_exactly_what_the_law_reads(name):
    block = BENCH.config(name)["scene"]
    assert set(block) == scenes.LAW_KEYS[block["law"]]
    small = dict(block, n=500)
    with pytest.raises(ValueError):
        scenes.generate({**small, "unused": 1}, 1, "cpu")
    missing = dict(small)
    missing.pop("sh_degree")
    with pytest.raises(ValueError):
        scenes.generate(missing, 1, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_scene(name):
    block = dict(BENCH.config(name)["scene"], n=3000)
    a = scenes.generate(block, 2**31 + 99, "cpu")
    b = scenes.generate(block, 2**31 + 99, "cpu")
    c = scenes.generate(block, 2**31 + 100, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["means"], c["means"])
    assert a["means"].shape == (3000, 3) and a["sh"].shape == (3000, 16, 3)
    assert all(v.dtype == torch.float32 for v in a.values())


def _stats(s):
    get = (lambda k: s[k]) if isinstance(s, dict) else \
        (lambda k: getattr(s, k))
    return {"scale_median": float(get("scales").median()),
            "opacity_mean": float(get("opacities").mean()),
            "opacity_std": float(get("opacities").std()),
            "dc_std": float(get("sh")[:, 0].std()),
            "rest_std": float(get("sh")[:, 1:].std()),
            "radius_mean": float(get("means").norm(dim=1).mean())}


def test_laws_match_the_port_fixtures():
    n = 20000
    surf = BENCH.config("surface-3m")["scene"]
    ours = scenes.generate(dict(surf, n=n), 5, "cpu")
    port = stt.surface_scene(n, seed=0, device="cpu")
    a, b = _stats(ours), _stats(port)
    for k in ("scale_median", "opacity_mean", "opacity_std", "rest_std",
              "dc_std"):
        assert a[k] == pytest.approx(b[k], rel=0.05), k
    # the blobs' layout differs from seed 0's at 20k; the scene's reach
    # does not
    assert a["radius_mean"] == pytest.approx(b["radius_mean"], rel=0.25)
    rnd = BENCH.config("random-1m")["scene"]
    ours = scenes.generate(dict(rnd, n=n), 5, "cpu")
    port = stt.random_scene(n, seed=0, extent=3.0,
                            scale_range=(0.004, 0.03), device="cpu")
    a, b = _stats(ours), _stats(port)
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=0.05), k


def test_surface_blobs_are_surface_scene_seed_0_at_3m():
    # surface_scene draws each blob's centre and radius, then its points,
    # from one NumPy generator: at 3M and seed 0 these are the blobs
    block = BENCH.config("surface-3m")["scene"]
    rng = np.random.default_rng(0)
    per = block["n"] // (len(block["blobs"]) + 1)
    for blob in block["blobs"]:
        centre = rng.uniform(-0.5, 0.5, 3) * block["extent"]
        radius = rng.uniform(0.2, 0.5) * block["extent"]
        rng.normal(size=(per, 3))
        assert blob["center"] == pytest.approx(list(centre), abs=1e-6)
        assert blob["radius"] == pytest.approx(radius, abs=1e-6)
