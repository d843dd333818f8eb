"""chip_smoke.py's multi-device phase (phase 9) on a CPU world of 2 gloo
ranks at a tiny size, the launcher's handling of a rank that fails, and
the repairs of the parallel layer that the phase's run on four cards
called for (slabs equal to one card's render, the rank's own card, the
a2a cap's memo).

The rank body (``chip_smoke.parallel_rank``) is the one the card runs,
one NCCL rank a card; here every kernel wrapper takes its plain version,
so the launch counters must stay 0.  Beside that world a second one runs
whose rank 1 raises once the world is up: rank 0 then blocks in its next
collective, and the launcher must kill it and raise with rank 1's
standard error long before its timeout.  Torch only: no JAX here."""

import copy
import os
import sys
import threading
import time
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import splat_tpu_torch as stt  # noqa: E402
from splat_tpu_torch.parallel import dryrun, sharding  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
# at most ~1k gaussians, 64 x 64, one fit step; a 32 x 32 frame holds one
# 32-px tile, so every gaussian makes one pair per tile it touches and
# dup 3 holds them all
TINY = {"n": 128, "dup": 3.0, "h": 32, "w": 32, "frames": 2, "steps": 1,
        "fit_dup": 3.0, "slab_ways": [2, 4, 8], "check_ply": None,
        "check_n": 64, "check_h": 32, "check_w": 32}
TIMEOUT = 120.0
FAIL_TIMEOUT = 60.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The phase's world of 2 and, at the same time, a world of 2 whose
    rank 1 raises; returns the results and how the failing one ended."""
    tmp = tmp_path_factory.mktemp("chip_smoke_ranks")
    os.makedirs(tmp / "ok")
    os.makedirs(tmp / "fail")
    failure: dict = {}

    def failing():
        t0 = time.monotonic()
        try:
            chip_smoke.run_parallel_world(WORLD, "cpu",
                                          {**TINY, "fail_rank": 1},
                                          str(tmp / "fail"), FAIL_TIMEOUT)
        except RuntimeError as e:
            failure["error"] = str(e)
        failure["seconds"] = time.monotonic() - t0

    thread = threading.Thread(target=failing)
    thread.start()
    try:
        results = chip_smoke.run_parallel_world(WORLD, "cpu", TINY,
                                                str(tmp / "ok"), TIMEOUT)
    finally:
        thread.join()
    return results, failure


def test_parent_checks_pass_on_the_rank_results(world):
    results, _ = world
    got = chip_smoke.check_parallel(results, TINY, on_card=False)
    assert got["world_size"] == WORLD
    assert set(got["frames"]) == {"random", "surface", "random_weak"}
    assert got["frames"]["random_weak"]["n"] == WORLD * TINY["n"]
    assert set(got["batch"]) == {f"{WORLD}x1"}
    assert set(got["fits"]) == {f"tp_1x{WORLD}", f"dp_{WORLD}x1"}
    assert got["fits"][f"dp_{WORLD}x1"]["local_views"] == 1
    assert got["launch_totals"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    # what a rank receives from the other: the records, the a2a slots of
    # 13 floats and a mask float, the other slab
    b = got["frames"]["random"]["bytes_per_frame"]
    n_local = TINY["n"] // WORLD
    assert b == {"record_gather": n_local * 52,
                 "a2a_records_and_mask": n_local * 56,
                 "slab_gather": TINY["h"] // WORLD * TINY["w"] * 12}


def _miss(results, what):
    """A copy of the results with one figure past its limit."""
    bad = copy.deepcopy(results)
    r1 = bad[1]
    if what == "overflow":
        r1["frames"]["surface"]["a2a"]["overflow"] = 1
    elif what == "replicas_apart":
        r1["frames"]["random"]["gather"]["spread"] = 1e-3
    elif what == "slab_psnr":
        bad[0]["frames"]["random_weak"]["a2a"]["psnr"] = 40.0
    elif what == "kernel_on_card_1":
        r1["kernels"]["K2_err"] = 1e-3
    elif what == "fit_loss":
        fig = bad[0]["fits"][f"tp_1x{WORLD}"]
        fig["losses"] = [x * 1.01 for x in fig["losses"]]
    elif what == "counted_on_cpu":
        r1["launches"]["batch_2x1"]["K2"] = 1
    return bad


@pytest.mark.parametrize("what", ["overflow", "replicas_apart", "slab_psnr",
                                  "kernel_on_card_1", "fit_loss",
                                  "counted_on_cpu"])
def test_parent_checks_refuse_a_miss(world, what):
    with pytest.raises(RuntimeError):
        chip_smoke.check_parallel(_miss(world[0], what), TINY,
                                  on_card=False)


def test_failing_rank_fails_the_launcher_within_its_timeout(world):
    _, failure = world
    assert "rank 1 of 2 exited with code 1" in failure["error"]
    assert "rank 1 fails on purpose" in failure["error"]  # its stderr
    assert failure["seconds"] < FAIL_TIMEOUT / 2


def test_ranks_outliving_the_timeout_are_killed(tmp_path):
    procs = dryrun.start_ranks(
        [sys.executable, "-c", "import time; time.sleep(60)"], 2, "cpu",
        str(tmp_path / "store"))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="still ran after"):
        dryrun.join_ranks(procs, timeout=1.0)
    assert time.monotonic() - t0 < 10.0
    assert all(p.poll() is not None for p in procs)


@pytest.mark.parametrize("ways", [4, 8])
def test_slab_split_equals_one_card_render(ways):
    """Opaque splats whose tiles stop on K2's whole-tile exit, split into
    slabs of 26 or 13 rows (16-px tiles, 16-pair windows): each slab is
    binned on whole tiles of the image's grid, its pair runs where one
    card's buffer has them, so the stitched slabs equal one
    render_tiled bit for bit."""
    from splat_tpu_torch.ops.projection import project_gaussians
    scene = stt.random_scene(2000, seed=0, extent=1.0,
                             scale_range=(0.08, 0.4), device="cpu")
    scene = stt.GaussianScene(
        means=scene.means, quats=scene.quats, scales=scene.scales,
        opacities=torch.full_like(scene.opacities, 0.9), sh=scene.sh)
    cam = stt.Camera.create(h=104, w=128, position=(0.0, 0.0, 4.0),
                            device="cpu")
    cfg = stt.RenderConfig(max_dup_factor=8.0, chunk=16, tile_px=16)
    want = stt.render_tiled(scene, cam, cfg)
    proj = project_gaussians(scene, cam, cfg)
    rows = 104 // ways
    parts = [sharding.render_slab_tiled(proj, g * rows, rows, 128, cfg)
             for g in range(ways)]
    assert all(int(ov) == 0 for _, ov in parts)
    assert torch.equal(torch.cat([p for p, _ in parts]), want)


def _fake_mesh(device_type: str):
    return types.SimpleNamespace(
        mesh_dim_names=sharding.MESH_DIMS, shape=(1, 1),
        device_type=device_type, get_group=lambda i: None,
        get_local_rank=lambda i: 0)


@pytest.mark.parametrize("index", [0, 2])
def test_sharded_tensors_must_lie_on_the_ranks_card(monkeypatch, index):
    """A rank computing on card 0 refuses a scene on card 2 (built, say,
    on another rank's device); no card is needed to tell."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    t = types.SimpleNamespace(device=torch.device("cuda", index))
    if index == 0:
        sharding._check_device(_fake_mesh("cuda"), t)
    else:
        with pytest.raises(ValueError, match="this rank computes on cuda:0"):
            sharding._check_device(_fake_mesh("cuda"), t)


def test_cap_factor_memo_lives_on_the_scene(monkeypatch):
    scene = stt.random_scene(64, seed=1, device="cpu")
    calls = []
    real = sharding.shard_spatial_score
    monkeypatch.setattr(sharding, "shard_spatial_score",
                        lambda s, n_g: calls.append(1) or real(s, n_g))
    first = sharding._auto_cap_factor(scene, 4)
    for _ in range(300):        # other scenes scored: no effect on this one
        sharding._auto_cap_factor(scene.slice(0, 32), 4)
    assert sharding._auto_cap_factor(scene, 4) == first
    assert len(calls) == 301
