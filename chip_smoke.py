"""Smoke run of the PyTorch + CUDA port (``splat_tpu_torch``) on the GPUs.

Run from the root of a checkout on a machine with NVIDIA Hopper cards
(phase 9 takes every visible card, one rank a card; the rest card 0):

    python3 chip_smoke.py [--only-parallel]

Phases (any failure raises and exits non-zero):
  1. print the card's name and power limit, build the CUDA kernels from
     ``splat_tpu_torch/csrc`` and print the build time;
  1b. the projection front end (``render/front.py``, kernel
     ``csrc/project.cu``) against its plain version at the 1M random, 1M
     surface and 3M surface frames @1920x1080: every output equal bit for
     bit (with and without the cull rows) and the count-only form's two
     counts; the kernel's device time, the whole call's (the camera
     record's ops included) and device ops a call, the plain version's
     device time, and the bound of each form;
  2. kernel K1 (pair expansion) against its plain PyTorch version at 1M
     random gaussians @1920x1080 and at 1M surface gaussians: keys, owners,
     tile edges, num_pairs and overflow must be exactly equal;
  3. kernel K2 (tile compositing) against its plain version on the same
     two frames: max abs difference <= K2_TOL, and at the surface frame,
     whose heavy tiles the kernels split across blocks, at least one tile
     split; then K2 alone at the surface-3m benchmark cell's frame (its
     configuration's scene at ORBIT_SEED, the orbit's heaviest sampled
     pose, render()'s capacity), whose long tiles K2 cuts into depth
     segments: segments planned there and none at the random frame, each
     frame's segments planned and re-walked printed, and a frame with
     segments within SEGMENT_ATOL of its plain version;
  3b. kernels K3 and K4 (the training forward and backward) against their
     plain versions on the same two frames: C and logT max abs <=
     K3_TOL, the per-tile cut equal, and K4's per-gaussian gradients per
     field within K4_REL_TOL of the field's largest value, cosine >=
     K4_MIN_COS; prints the longest tile walk and both kernels' times;
  4. the inference path with every launch counter at 0: ``render()`` of
     the committed fitted 20k-splat scene (>= 45 dB against the dense
     renderer), then ``render()`` and a timed yaw sweep (``chained_bench``,
     one captured CUDA graph) of 1M random and 1M surface gaussians
     @1920x1080 with overflow 0, each scene packed by ``pack_device()``
     as the repo's bench.py packs it;
  5. K1 and K2 must have launched during phase 4, and the front end as
     often as K1 (once a frame), and once count-only (the fitted scene's
     capacity);
  6. the training path with every launch counter at 0: the fitted-20k
     recipe of scripts/make_fitted_scene.py (surface_scene(20_000), 4
     orbit poses at 400x300, perturbed start, ``fit(method="tiled")``,
     L2 + L1 + D-SSIM, lr 5e-3, FIT_STEPS steps; targets from the port's
     ``render_dense``) must more than halve its loss with every loss
     finite; then timed tiled ``fit`` steps on 1M surface gaussians
     @1920x1080 with 2 orbit views and overflow 0;
  7. K3 and K4 must have launched during phase 6; the front end once
     count-only a view in each fit's capacity audit and each step's
     demand pass, and once a frame of the two target renders alone;
  8. the command line and the viewer, with every launch counter at 0
     before the inference commands and again before ``fit``: the 1M
     surface scene saved as a PLY and loaded by the native loader (its
     arrays equal the NumPy reader's: positions, rotations and SH exactly,
     the exp-activated fields to rtol 1e-6), by the NumPy reader and from
     the warm npz cache, each timed; ``info``; ``render`` @1920x1080 with
     ``--dup-factor auto --stats`` (its PNG within 1 of ``stt.render`` in
     uint8, overflow 0); ``orbit --path`` over SE(3) views of the fitted
     20k scene @400x300 (each frame >= 45 dB against ``render_dense``); a
     10-frame ``orbit`` and a 30-frame ``bench`` of 1M gaussians @1080p
     with no overflow; the viewer from ``make_server`` serving the 1M
     surface scene @1080p (raw, PNG, depth, 0.5x and 2.0x frames with
     overflow 0, the first raw frame within 1 of the render, the median
     pose-to-bytes time of 10 raw requests); ``fit --targets --cameras``
     over those SE(3) views, 30 tiled steps, loss more than halved.  K1
     and K2 must launch on the inference commands, the front end as often
     as K1; K3 and K4 on ``fit``, the front end count-only once a view in
     the audit and each step and once for the final renders' capacity,
     and a frame for each final render and the capture's warm-up.
     Prints a JSON line of the phase's times.
  9. the multi-device paths (``splat_tpu_torch.parallel``, ``fit(mesh=)``)
     on a world of one NCCL rank a visible card: this script started again
     once a rank (``--rank r --world N``, through
     ``parallel.dryrun.start_ranks``/``join_ranks``: a failing rank fails
     the phase at once, with its standard error), rank r on card r, each
     writing its results under ``build/``; this process holds them to the
     limits (``check_parallel``).  On every card: K1-K4 against their
     plain versions on the fitted 20k scene @400x300, to phase 2-3b's
     limits.  At 1920x1080, each path's launches counted from 0 on every
     rank (K1 and K2 must launch on each render path): the 1M random and
     the 1M surface frame by ``render_sharded_tiled`` on mesh (1, N), both
     routes, and ``random_scene(N x 1M)`` (1M a card) alike, each image
     within the slab limits of tests/test_sharding.py (>= SLAB_MIN_PSNR,
     under SLAB_MAX_DIFF_SHARE of pixels off by more than 1e-6) of one
     card's ``render_tiled`` of the whole scene on rank 0, the same on
     every rank, a2a within A2A_GATHER_TOL of gather, overflow 0, the
     packed shard's image equal to the unpacked one's; the 8 yaw frames of
     the surface scene by ``render_batch_sharded_tiled`` on (N, 1) (and
     (2, 2) on four cards), each frame within the same limits; on rank 0
     the 2-, 4- and 8-way slab split by ``render_slab_tiled``, stitched,
     same limits.  Then phase 6's 1M surface recipe, BIG_FIT_STEPS tiled
     steps by ``fit(mesh=)``: 2 views on (1, N) (tensor parallel over
     'g') and N views on (N, 1) (data parallel over 'd'), each loss
     history within max(FIT_LOSS_RTOL, FIT_GAP_FACTOR x the single-card
     run-to-run gap) of the nearer of two single-card fits on rank 0, the
     whole fitted parameters finite and moved, K3 and K4 launched once a
     local view and step.  Last, ``python -m
     splat_tpu_torch.parallel.dryrun --world N`` must exit 0.  Prints the
     link between the cards (``nvidia-smi topo -m``) and a
     ``{"parallel": ...}`` JSON line: ms per frame and per step (CUDA
     events between syncs of every rank, the slowest rank's) beside one
     card's on the same frames and steps, the bytes a rank receives a
     frame by each collective, the losses and the launch counts.
     ``--only-parallel`` runs phases 1 and 9 alone (a machine of several
     cards).
  10. the two knobs at the 1M random and surface frames @1920x1080:
     ``cull_pairs``: K1's cull equal to its plain version (keys and owners),
     pairs culled, num_pairs the pairs kept, overflow 0, the image within
     alpha_min of the no-cull one and equal on tiles walked to their end,
     but within SEGMENT_ATOL on those K2 cut into depth segments (the
     culled pairs move the borders at which it merges their sums), and the
     no-cull image within SEGMENT_ATOL of the plain version's;
     ``subtile_exit``: K2's grouped walk within K2_TOL of its plain version,
     its image within SUBTILE_ATOL of the whole-tile one (the plain
     version's serial walk), and at the
     surface frame the heaviest tile on the grouped walk with groups that
     stop apart.  Then, each counted from 0 and held to exactly one K1 and
     one K2 launch a render with its knob's variant, and one front end
     launch a render but the slab split's: ``stt.render`` with
     each knob (equal bit for bit to ``rasterize_tiles`` on the same bins
     and to ``render_tiled``), ``render_tiled`` with both, a 2-way slab
     split with both (within alpha_min of it), and yaw sweeps of each
     setting in turns.  Prints a ``{"knobs": ...}`` JSON line.
  11. the feature-major scene (``pack_device()``, one (59, N) buffer) at
     the 1M random and surface frames @1920x1080: the pack's time and its
     fields equal to the scene's; the frame's front end on both layouts
     (a ``GaussianScene`` is packed afresh in the call), its outputs equal
     bit for bit, its time with CUDA events (PROJ_REPS calls behind the
     spinning kernel), its device-busy time and device ops a call from
     ``torch.profiler``; ``render_tiled`` on both layouts equal bit for
     bit, and to the frame binned from the plain front end, overflow 0;
     ``stt.render`` of a ``GaussianScene`` packing once over 3 frames and
     equal to ``render_tiled`` of the pack, with K1, K2 and the front end
     launched once a frame, counted from 0; yaw sweeps of both layouts
     in turns (unpacked, packed, packed, unpacked).  Phase 9 adds
     ``render_sharded_tiled`` of the packed scene's shard, by both
     routes, equal bit for bit to the unpacked shard's.
     Prints a ``{"packed": ...}`` JSON line.
  12. the compiled frame (``render/graph.py``: a frame captured once into
     a CUDA graph and replayed, the port's ``jax.jit``) at the 1M random
     and surface frames @1920x1080, packed: ``render_fn``'s first call
     (capture ms, its pool's MiB) beside one eager frame; its replays
     equal to eager ``render_tiled`` bit for bit at the captured pose, at
     a new pose (that replay traced by ``torch.profiler``: one K1, one K2
     and one front end kernel on the card, as many as the counters add
     from 0), after an
     in-place edit of the packed buffer and after its undo, with one
     capture in all; ``stt.render`` of a ``GaussianScene`` edited in
     place between 3 frames and of one of inference tensors, each one
     capture, equal to eager, reserved memory (the eager reference
     frames' cached blocks released) and allocated memory flat after the
     first frame;
     ``chained_bench``'s 30-frame sweep as one captured program against
     eager dispatch, in turns (eager, compiled, compiled, eager), the
     same mean pixel bit for bit, and a 10-frame sweep program of each
     under ``torch.profiler`` (device-busy ms a frame, idle share of the
     median sweep); one replay of that captured program traced: ten of
     each of the three kernels on the card, as many as the counters add;
     the CLI ``orbit`` of the 1M random PLY (one capture, a replay a
     frame, K1, K2 and the front end launched frames + 1 times); the
     viewer's ``render_pose`` equal to eager bit for bit and the median pose ->
     bytes of raw requests through its graph (surface).  Prints a
     ``{"compiled": ...}`` JSON line.
  Every inference entry point above (``render``, ``render_fn``,
  ``chained_bench``, the CLI and the viewer) replays captured graphs: a
  capture's eager warm-up launches K1 and K2 once more for each frame it
  captures, which phases 10 and 11 count; the cache of graphs is emptied
  after each phase that fills it.
The second-to-last line is a JSON object describing each kernel, with its
bound (the least time the card could take for its work on these inputs,
``splatbench/roofline.py``'s ``least_seconds`` at that file's H100 SXM
peaks: bytes over the memory rate, FP32 operations over the FP32 rate, or
special-function operations over the SFU rate, whichever is largest;
``bound_by`` names it ``bytes``, ``fp32`` or ``sfu``), and
the surface frame's figures under ``surface_*`` keys;
the last line is ``{"ok": true, "device": {...}}``.  Exits non-zero with no
result line when no CUDA device is available.  The port imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

from splatbench.roofline import (ALPHA_OPS, K2_KEPT_OPS, K2_KEPT_SFU,
                                 K3_KEPT_OPS, K3_KEPT_SFU, K4_KEPT_OPS,
                                 K4_KEPT_SFU, PROJ_OPS, PROJ_SFU,
                                 SFU_OPS_PER_S, least_seconds)

ROOT = os.path.dirname(os.path.abspath(__file__))
FITTED_PLY = os.path.join(ROOT, "tests", "data", "fitted_20k.ply")
N_BIG = 1_000_000
H, W = 1080, 1920
# K2 tolerance: kernel and plain version do the same f32 operations in the
# same order; only library rounding (expf) may differ.
K2_TOL = 1e-4
# where K2 cuts tiles into depth segments it also reassociates the sum over
# them: the largest drift read on an H100 was 1.07e-6 at the 1M surface
# frame and 1.97e-6 at the surface-3m cell's (phase 3), held to five times
# that
SEGMENT_ATOL = 1e-5
# phase 3: the seed of the surface-3m cell's scene and orbit (PERF.md's
# traced seed)
ORBIT_SEED = 2600001211
FITTED_MIN_PSNR = 45.0
SWEEP_FRAMES = 30
# K3: the same f32 operations in the same order as its plain version; only
# expf/log1pf rounding may differ.
K3_TOL = 1e-4
# K4: atomics add the tiles' pair sums into each gaussian in a run-dependent
# order, and the pixel sums run in another order than torch's.
K4_REL_TOL = 1e-4
K4_MIN_COS = 0.99999
FIT_STEPS = 30
BIG_FIT_STEPS = 3
ORBIT_FRAMES = 10          # phase 8: the CLI orbit of the 1M surface PLY
COMPILED_ORBIT_FRAMES = 5  # phase 12: the CLI orbit of the 1M random PLY
VIEWER_REQUESTS = 10       # phase 8: timed raw requests at 1080p
# phase 9: a slab-split render against one render_tiled, the limits
# tests/test_sharding.py holds splat_tpu's to (its slabs cut the image's
# tiles elsewhere, so K2's whole-tile exit falls elsewhere; the port bins a
# slab on the image's own tiles and windows)
SLAB_MIN_PSNR = 55.0
SLAB_MAX_DIFF_SHARE = 0.002
PARALLEL_FRAMES = 8
# phase 9: a sharded fit against the nearer of two single-card fits (K4's
# atomics add in a run-dependent order; on the H100 two single-card runs
# of the same 3 steps differed by 9.66e-6 relative, and at world size 1
# the mesh's history equalled one of them exactly: PERF.md, section 5).
# Across cards the tolerance is FIT_GAP_FACTOR times the run-to-run gap
# measured in the same phase, never below FIT_LOSS_RTOL (check_parallel).
FIT_LOSS_RTOL = 1e-5
FIT_GAP_FACTOR = 10.0
# phase 9: the a2a route's image against the gather route's
A2A_GATHER_TOL = 1e-5
# phase 9: the world's sizes (parallel_rank), and its time limit in seconds
PARALLEL_SIZES = {"n": N_BIG, "dup": None, "h": H, "w": W,
                  "frames": PARALLEL_FRAMES,
                  "steps": BIG_FIT_STEPS, "fit_dup": 1.45,
                  "slab_ways": [2, 4, 8],
                  "check_ply": FITTED_PLY, "check_h": 300, "check_w": 400}
PARALLEL_TIMEOUT = 300.0
# phase 10: the subtile_exit image against the whole-tile one, at the
# tolerance tests/test_tiled.py holds splat_tpu's to (a group stops only
# once its pixels have T < alpha_min / 4096, so it leaves out less)
SUBTILE_ATOL = 1e-6
# phase 1b: the projection front end's kernel and its plain version at
# these frames (N, scene), each @1920x1080 from (0, 0, 4); bytes a gaussian
# of its full and count-only forms (59 f32 rows in and six int32 fields
# and 11 f32 rows out; rows 0-10 in); its operations are the yardstick's
# projection
FRONT_FRAMES = ((N_BIG, "random"), (N_BIG, "surface"), (3_000_000, "surface"))
FRONT_BYTES, FRONT_COUNT_BYTES = 236 + 68, 44
# phase 11: front ends timed with CUDA events, profiled, and packs timed
PROJ_REPS = 20
PROFILE_REPS = 5
PACK_REPS = 5
# A short kernel is timed behind this many cycles of a spinning kernel, so
# that the host has queued every launch before the first one starts
# (~5 ms; K1 takes less on the card than its wrapper takes on the host).
HOLD_CYCLES = 10_000_000


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# the counters a kernel wrapper adds its launches to
COUNTERS = ("launches", "count_launches")


def saved_launches(kernels) -> list:
    """Every launch counter of the wrappers, to put back later."""
    return [(fn, a, getattr(fn, a)) for fn in kernels for a in COUNTERS
            if hasattr(fn, a)]


def restore_launches(saved: list) -> None:
    for fn, a, v in saved:
        setattr(fn, a, v)


def zero_launches(kernels) -> None:
    """Every launch counter of the wrappers at 0: K1-K4's, and the front
    end's frames and count-only launches."""
    restore_launches([(fn, a, 0) for fn, a, _ in saved_launches(kernels)])


def front_launches(front) -> dict:
    """The front end's frame launches and its count-only ones."""
    return {"front": front.launches - front.count_launches,
            "front_count": front.count_launches}


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_record(name, source, replaces, err, ms, plain_ms, nbytes, ops,
                  sfu=0.0):
    bound_s, bound_by = least_seconds(nbytes, ops, sfu)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": None}


def bench_scene(kind: str, n: int, device):
    """The scenes and capacities of the repo's bench.py headline cells."""
    import splat_tpu_torch as stt
    if kind == "surface":
        return stt.surface_scene(n, seed=0, device=device), 1.45
    return stt.random_scene(n, seed=0, extent=3.0, scale_range=(0.004, 0.03),
                            device=device), 2.05


def orbit_frame(device):
    """The surface-3m benchmark cell's frame at the heaviest pose of its
    orbit that the cell's set-up samples: its configuration's scene at
    ORBIT_SEED, binned by the main path at render()'s capacity.  Returns
    (bins, config, pose index)."""
    import splat_tpu_torch as stt
    from splat_tpu_torch.render.binning import bin_front
    from splat_tpu_torch.render.front import project_front
    from splatbench import poses, scenes

    with open(os.path.join(ROOT, "splatbench", "configs",
                           "surface-3m.json")) as f:
        conf = json.load(f)
    with open(os.path.join(ROOT, "splatbench", "traffic", "orbit.json")) as f:
        traffic = json.load(f)
    leaves = scenes.generate(conf["scene"], ORBIT_SEED, device)
    scene = stt.GaussianScene.create(**leaves, device=device).pack_device()
    del leaves
    base = poses.base_pose(conf["camera"], device)
    yaws, pitches = poses.orbit_path(traffic, ORBIT_SEED, device)

    def cam(i):
        return stt.Camera(**dict(base, yaw=yaws[i], pitch=pitches[i]))

    stride = int(traffic["warm_stride"])
    loads = [stt.pair_stats(scene, cam(i))["num_pairs"]
             for i in range(0, yaws.numel(), stride)]
    heavy = stride * max(range(len(loads)), key=loads.__getitem__)
    cfg = stt.auto_config(scene, cam(heavy))
    bins = bin_front(project_front(scene, cam(heavy), cfg), base["h"],
                     base["w"], cfg)
    return bins, cfg, heavy


def check_expand(proj, h, w, cfg):
    """Phase 2: K1 against its plain version, exactly.  Returns the
    kernel record and the frame's bins (which phase 3 reuses)."""
    import torch
    from splat_tpu_torch.render import binning
    from splat_tpu_torch.render.expand import expand_pair_keys_plain

    lay = binning.slot_layout(proj, h, w, cfg)
    keys, owners = lay.expand()
    keys_p, owners_p = lay.expand(expand_pair_keys_plain)
    torch.cuda.synchronize()
    require(torch.equal(keys, keys_p), "K1 keys differ from the plain version")
    require(torch.equal(owners, owners_p), "K1 owners differ")
    nt = lay.tiles_x * lay.tiles_y
    edges = binning.tile_edges(torch.sort(keys, stable=True)[0], nt)
    edges_p = binning.tile_edges(torch.sort(keys_p, stable=True)[0], nt)
    require(torch.equal(edges, edges_p), "K1 tile edges differ")
    bins = binning.build_tile_bins(proj, h, w, cfg)
    _, pairs = binning.count_pairs(proj, h, w, cfg)
    num_pairs, overflow = int(bins.num_pairs), int(bins.overflow)
    require(num_pairs == int((edges[1:] - edges[:-1]).sum()),
            "num_pairs differs from the walked tile ranges")
    require(num_pairs + overflow == int(pairs),
            "num_pairs + overflow differs from the true pair count")
    ms = cuda_ms(lay.expand, 20)
    plain_ms = cuda_ms(lambda: lay.expand(expand_pair_keys_plain), 5)
    n = lay.first_slot.shape[0]
    # reads first_slot (8 B), tx0/ty0/span_w/depth bits (4 B each) per
    # gaussian; writes a key and an owner (8 B each) per slot
    rec = kernel_record("expand_pair_keys", "splat_tpu_torch/csrc/expand.cu",
                        "splat_tpu/render/expand.py:85",
                        float((keys - keys_p).abs().max()), ms, plain_ms,
                        24 * n + 8 + 16 * lay.k_cap, 0)
    rec["longest_walk"] = int((bins.tile_end - bins.tile_start).max())
    print(f"[K1] expand_pair_keys: k_cap={lay.k_cap} pairs={num_pairs} "
          f"overflow={overflow}: exact match; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    return rec, bins


def check_raster(bins, h, w, cfg, plain_reps: int) -> dict:
    """Phase 3 on one frame: K2 against its plain version.  The plain
    version is timed over ``plain_reps`` calls, or, with 0, as the one call
    that is compared."""
    import torch
    from splat_tpu_torch.render.kernels import (rasterize_tiles,
                                                rasterize_tiles_plain)

    img = rasterize_tiles(bins, h, w, cfg)
    split = int(rasterize_tiles.split_tiles)
    segments = rasterize_tiles.segments.tolist()
    t0 = time.perf_counter()
    img_p, walked = rasterize_tiles_plain(bins, h, w, cfg,
                                          return_walked=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    require(img.shape == (h, w, 3) and bool(torch.isfinite(img).all()),
            f"K2 image shape {tuple(img.shape)} or non-finite values")
    err = float((img - img_p).abs().max())
    tol = SEGMENT_ATOL if segments[0] else K2_TOL
    require(err <= tol, f"K2 max abs error {err} > {tol}")
    ms = cuda_ms(lambda: rasterize_tiles(bins, h, w, cfg), 20)
    if plain_reps:
        plain_ms = cuda_ms(lambda: rasterize_tiles_plain(bins, h, w, cfg),
                           plain_reps)
    nt = bins.tiles_x * bins.tiles_y
    # the work of the pairs K2's exit lets each tile walk, over every tile
    # pixel (pixels past the image edge are composited too: they vote);
    # the bytes too: the features of a pair past the exit are never read
    work = walk_work(bins, h, w, cfg, walked)
    rec = kernel_record("rasterize_tiles", "splat_tpu_torch/csrc/raster.cu",
                        "splat_tpu/render/kernels.py:123", err, ms, plain_ms,
                        44 * work["walked"] + 8 * nt + 12 * h * w,
                        ALPHA_OPS * work["box3"] + K2_KEPT_OPS * work["kept3"],
                        work["box3"] + K2_KEPT_SFU * work["kept3"])
    # the bound of alpha evaluations alone at every walked (pixel, pair)
    rec["alpha_only_bound_ms"] = least_seconds(
        0, ALPHA_OPS * work["walked"] * cfg.tile_w * cfg.tile_h, 0)[0] * 1e3
    rec["split_tiles"] = split
    rec["segments"], rec["segments_rewalked"] = segments
    rec["longest_walk"] = int(walked.max())
    print(f"[K2] rasterize_tiles: max abs err {err:.3e} (tol {K2_TOL}); "
          f"{work['walked']} of {int(bins.num_pairs)} pairs walked, longest "
          f"tile walk {rec['longest_walk']}, {split} tiles split, "
          f"{segments[0]} depth segments ({segments[1]} re-walked); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {work['box3']} "
          f"pixel-pair evaluations in the box, {work['kept3']} kept; "
          f"alpha-only bound {rec['alpha_only_bound_ms']:.4f} ms)")
    return rec


def walk_work(bins, h, w, cfg, n, group_n=None):
    """What a walk of the first ``n[t]`` pairs of every tile t must
    compute, from the plain version's alpha on the same pairs: the pairs
    walked, and the (pixel, pair) evaluations in the pair's box and the
    kept ones, over every tile pixel (K2, K3) and over the pixels inside
    the image (K4).  With ``group_n`` ((T, G) pairs walked by each 8 x 16
    pixel group, subtile_exit), a pixel counts only the first
    ``group_n[t, g]`` pairs of its tile, and ``n`` is their maximum."""
    import torch
    from splat_tpu_torch.render import diff
    from splat_tpu_torch.render.kernels import GROUP_H, GROUP_W

    dev = bins.features.device
    s = bins.tile_start.long()
    tid = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    total = int(n.sum())
    k = s[tid] + torch.arange(total, device=dev) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    pxf, pyf = diff._pixel_grid(bins, cfg, dev)
    inside = diff._tile_pixels(torch.ones((h, w, 1), dtype=torch.bool,
                                          device=dev), bins, cfg)[..., 0]
    use_bbox = math.isfinite(cfg.sigma_cutoff)
    if group_n is not None:
        lin = torch.arange(cfg.tile_w * cfg.tile_h, device=dev)
        gid = ((lin // cfg.tile_w // GROUP_H) * (cfg.tile_w // GROUP_W)
               + (lin % cfg.tile_w) // GROUP_W)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    step = max(1, (1 << 25) // pxf.shape[1])
    for i in range(0, total, step):
        kk, tt = k[i:i + step], tid[i:i + step]
        fk = bins.features[:, kk]
        f = [fk[q][:, None] for q in range(fk.shape[0])]
        _, _, _, keep, _, _, dx2, dy2 = diff._alpha(f, pxf[tt], pyf[tt], cfg,
                                                    use_bbox)
        box = ((dx2 <= f[9]) & (dy2 <= f[10]) if use_bbox
               else torch.ones_like(keep))
        if group_n is not None:     # the pixel's group still walks
            live = (kk - s[tt])[:, None] < group_n[tt][:, gid]
            box, keep = box & live, keep & live
        ins = inside[tt]
        counts += torch.stack([box.sum(), keep.sum(), (box & ins).sum(),
                               (keep & ins).sum()])
    box3, kept3, box4, kept4 = counts.tolist()
    return {"walked": total, "box3": box3, "kept3": kept3, "box4": box4,
            "kept4": kept4}


def check_train(bins, h, w, cfg):
    """Phase 3b on one frame: K3 and K4 against their plain versions.
    Returns the two kernel records."""
    import torch
    from splat_tpu_torch.render import diff

    c, lt, cut = diff.rasterize_train_fwd(bins, h, w, cfg)
    split3 = int(diff.rasterize_train_fwd.split_tiles)
    t0 = time.perf_counter()
    c_p, lt_p, cut_p = diff.rasterize_train_fwd_plain(bins, h, w, cfg)
    torch.cuda.synchronize()
    plain3 = (time.perf_counter() - t0) * 1e3
    require(c.shape == (h, w, 3) and lt.shape == (h, w)
            and bool(torch.isfinite(c).all() & torch.isfinite(lt).all()),
            "K3: bad shape or non-finite values")
    err3 = max(float((c - c_p).abs().max()), float((lt - lt_p).abs().max()))
    require(err3 <= K3_TOL, f"K3 max abs error {err3} > {K3_TOL}")
    require(torch.equal(cut, cut_p), "K3 cut differs from the plain version")
    gen = torch.Generator(device=c.device).manual_seed(0)
    g_c = torch.randn((h, w, 3), generator=gen, device=c.device)
    g_lt = torch.randn((h, w), generator=gen, device=c.device)
    g = diff.rasterize_train_bwd(bins, g_c, g_lt, lt, cut, h, w, cfg)
    split4 = int(diff.rasterize_train_bwd.split_tiles)
    t0 = time.perf_counter()
    g_p = diff.rasterize_train_bwd_plain(bins, g_c, g_lt, lt, cut, h, w,
                                         cfg)
    torch.cuda.synchronize()
    plain4 = (time.perf_counter() - t0) * 1e3
    require(bool(torch.isfinite(g).all()), "K4: non-finite gradients")
    rel = max(float((g[:, q] - g_p[:, q]).abs().max())
              / (float(g_p[:, q].abs().max()) + 1e-30)
              for q in range(g.shape[1]))
    a, b = g.double().flatten(), g_p.double().flatten()
    cos = float(a @ b / (a.norm() * b.norm()))
    require(rel <= K4_REL_TOL, f"K4 per-field relative error {rel} > "
                               f"{K4_REL_TOL}")
    require(cos >= K4_MIN_COS, f"K4 cosine {cos} < {K4_MIN_COS}")
    err4 = float((g - g_p).abs().max())

    ms3 = cuda_ms(lambda: diff.rasterize_train_fwd(bins, h, w, cfg), 10)
    ms4 = cuda_ms(lambda: diff.rasterize_train_bwd(bins, g_c, g_lt, lt, cut,
                                                   h, w, cfg), 10)

    nt = bins.tiles_x * bins.tiles_y
    n = bins.num_gaussians
    pairs = int(bins.num_pairs)
    # windows [0, cut) of every tile: the pairs whose features are read
    walked = torch.clamp(diff._walk_end(bins, cfg.chunk, cut)
                         - bins.tile_start.long(), min=0)
    work = walk_work(bins, h, w, cfg, walked)
    longest = int(walked.max())
    k3 = kernel_record("rasterize_train_fwd",
                       "splat_tpu_torch/csrc/raster_train.cu",
                       "splat_tpu/render/diff.py:211", err3, ms3, plain3,
                       44 * work["walked"] + 12 * nt + 16 * h * w,
                       ALPHA_OPS * work["box3"] + K3_KEPT_OPS * work["kept3"],
                       work["box3"] + K3_KEPT_SFU * work["kept3"])
    # reads the features and owner of each pair, dL/dC, dL/dlogT and logT
    # per pixel; writes 9 floats per gaussian
    k4 = kernel_record("rasterize_train_bwd",
                       "splat_tpu_torch/csrc/raster_train.cu",
                       "splat_tpu/render/diff.py:360", err4, ms4, plain4,
                       52 * work["walked"] + 12 * nt + 20 * h * w + 36 * n,
                       ALPHA_OPS * work["box4"] + K4_KEPT_OPS * work["kept4"],
                       work["box4"] + K4_KEPT_SFU * work["kept4"])
    # the bound of alpha evaluations alone at every walked (pixel, pair)
    alpha_only = least_seconds(0, ALPHA_OPS * work["walked"] * cfg.tile_w
                               * cfg.tile_h, 0)[0] * 1e3
    for rec, split in ((k3, split3), (k4, split4)):
        rec["alpha_only_bound_ms"] = alpha_only
        rec["split_tiles"] = split
        rec["longest_walk"] = longest
    print(f"[K3] rasterize_train_fwd: max abs err {err3:.3e} (tol "
          f"{K3_TOL}), cut equal; {work['walked']} of {pairs} pairs "
          f"walked, longest tile walk {longest}, {split3} tiles split; "
          f"kernel {ms3:.4f} ms, plain {plain3:.1f} ms, bound "
          f"{k3['bound_ms']:.4f} ms ({k3['bound_by']}; {work['box3']} "
          f"pixel-pair evaluations in the box, {work['kept3']} kept; "
          f"alpha-only bound {alpha_only:.4f} ms)")
    print(f"[K4] rasterize_train_bwd: per-field rel err {rel:.3e} (tol "
          f"{K4_REL_TOL}), cosine {cos:.8f} (min {K4_MIN_COS}), max abs "
          f"err {err4:.3e}; {split4} tiles split; kernel {ms4:.4f} ms, "
          f"plain {plain4:.1f} ms, bound {k4['bound_ms']:.4f} ms "
          f"({k4['bound_by']}; {work['box4']} in the box, {work['kept4']} "
          f"kept)")
    return k3, k4


def front_mismatch(got, want) -> list:
    """The fields of two ``binning.GaussianFront`` (or two count tensors)
    that differ bit for bit."""
    import torch
    if isinstance(want, torch.Tensor):
        return [] if torch.equal(got, want) else ["counts"]
    bad = []
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a is None or b is None:
            if (a is None) != (b is None):
                bad.append(f.name)
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.shape != b.shape or not torch.equal(a, b):
            bad.append(f.name)
    return bad


def check_front(device) -> tuple[dict, dict]:
    """Phase 1b: the projection front end (``render/front.py``, kernel
    ``csrc/project.cu``) against its plain version at FRONT_FRAMES: every
    output bit for bit, with and without the cull rows, and the count-only
    form's two counts.  Times each form: the kernel alone and the whole
    call (the camera record's ops with it) as ``torch.profiler`` sees the
    card, the call with CUDA events, the plain version's device time.
    Returns the kernel records of the full and the count-only form (the
    1M random frame, the others under ``surface_*`` and ``surface3m_*``
    keys)."""
    import torch
    import splat_tpu_torch as stt
    from splat_tpu_torch.render.front import (project_front,
                                              project_front_plain)

    cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), device=device)
    recs = {}
    for n, kind in FRONT_FRAMES:
        scene, dup = bench_scene(kind, n, device)
        packed = scene.pack_device()
        del scene
        cfg = stt.RenderConfig(max_dup_factor=dup)
        tag = f"{kind} {n}"
        for c in (cfg, dataclasses.replace(cfg, cull_pairs=True)):
            bad = front_mismatch(project_front(packed, cam, c),
                                 project_front_plain(packed, cam, c))
            require(not bad, f"front end, {tag}, cull_pairs="
                             f"{c.cull_pairs}: {bad} differ from the plain "
                             f"version")
        got = project_front(packed, cam, cfg, count_only=True)
        want = project_front_plain(packed, cam, cfg, count_only=True)
        require(torch.equal(got, want), f"front end count-only, {tag}: "
                                        f"{got.tolist()} != {want.tolist()}")
        visible, pairs = want.tolist()
        forms = {}
        # the count-only form's bound is its bytes alone (it skips the SH)
        for form, count_only, nbytes, ops, sfu in (
                ("full", False, FRONT_BYTES, PROJ_OPS, PROJ_SFU),
                ("count", True, FRONT_COUNT_BYTES, 0, 0)):
            def call(co=count_only):
                return project_front(packed, cam, cfg, count_only=co)

            def plain(co=count_only):
                return project_front_plain(packed, cam, cfg, count_only=co)

            prof = profile_calls(call, PROFILE_REPS,
                                 match="project_front_kernel")
            prof_p = profile_calls(plain, PROFILE_REPS)
            name = "project_front" + ("_count" if count_only else "")
            rec = kernel_record(name, "splat_tpu_torch/csrc/project.cu",
                                "none: the XLA fusion of splat_tpu/ops/"
                                "projection.py and render/binning.py's "
                                "per-gaussian prep", 0.0, prof["match_ms"],
                                prof_p["busy_ms"], nbytes * n, ops * n,
                                sfu * n)
            rec.update(call_busy_ms=prof["busy_ms"],
                       call_device_ops=prof["kernels"],
                       call_event_ms=cuda_ms(call, PROJ_REPS),
                       plain_device_ops=prof_p["kernels"],
                       visible=visible, pairs=pairs, n=n)
            forms[form] = rec
            print(f"[front] {name} {tag} @{W}x{H}: every output equal to "
                  f"the plain version bit for bit ({visible} visible, "
                  f"{pairs} pairs); kernel {rec['ms']:.4f} ms, the call "
                  f"{rec['call_busy_ms']:.4f} ms busy in "
                  f"{rec['call_device_ops']:.0f} device ops "
                  f"({rec['call_event_ms']:.4f} ms by events), plain "
                  f"{rec['plain_ms']:.4f} ms busy in "
                  f"{rec['plain_device_ops']:.0f}, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        recs[(n, kind)] = forms
        del packed, got, want
        torch.cuda.empty_cache()
    out = []
    for form in ("full", "count"):
        rec = recs[FRONT_FRAMES[0]][form]
        for (n, kind), prefix in zip(FRONT_FRAMES[1:],
                                     ("surface", "surface3m")):
            rec.update({f"{prefix}_{key}": recs[(n, kind)][form][key]
                        for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "call_busy_ms", "call_device_ops",
                                    "call_event_ms", "visible", "pairs",
                                    "n")})
        out.append(rec)
    return tuple(out)


def main_path(device) -> None:
    """Phase 4: the port's entry points end to end."""
    import torch
    import splat_tpu_torch as stt
    from splat_tpu_torch.utils.benchmark import chained_bench

    scene = stt.load_ply(FITTED_PLY, center=False, device=device)
    cam = stt.Camera.create(h=300, w=400, position=(0.0, -1.0, 3.5),
                            device=device)
    img = stt.render(scene, cam)
    ref = stt.render_dense(scene, cam, chunk=64)
    p = stt.psnr(img, ref)
    require(img.shape == (300, 400, 3) and bool(torch.isfinite(img).all()),
            "fitted render: bad shape or non-finite values")
    require(p >= FITTED_MIN_PSNR,
            f"fitted 20k render vs dense: {p:.2f} dB < {FITTED_MIN_PSNR}")
    print(f"[main] fitted_20k @400x300: render() vs render_dense "
          f"{p:.2f} dB")

    cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), device=device)
    for kind in ("random", "surface"):
        scene, dup = bench_scene(kind, N_BIG, device)
        scene = scene.pack_device()              # as bench.py packs it
        cfg = stt.RenderConfig(max_dup_factor=dup)
        img = stt.render(scene, cam, cfg)        # raises on overflow
        require(img.shape == (H, W, 3) and bool(torch.isfinite(img).all()),
                f"{kind}: bad shape or non-finite values")
        r = chained_bench(scene, cam, cfg, SWEEP_FRAMES)
        require(r["overflow"] == 0, f"{kind}: overflow {r['overflow']}")
        print(f"[main] {kind} {N_BIG} @{W}x{H} dup {dup}, packed: "
              f"{r['ms_per_frame']:.3f} ms/frame ({r['fps']:.2f} FPS, "
              f"{SWEEP_FRAMES}-frame yaw sweep, CUDA events); "
              f"pairs={r['num_pairs']} visible={r['visible']} "
              f"overflow={r['overflow']} mean_pixel={r['mean_pixel']:.4f}")
        del scene


def training_path(device) -> None:
    """Phase 6: the fitted-20k recipe, then timed tiled fit steps on 1M
    surface gaussians @1920x1080."""
    import numpy as np
    import torch
    import splat_tpu_torch as stt
    from splat_tpu_torch.ops.projection import project_gaussians
    from splat_tpu_torch.render.binning import count_pairs

    n = 20_000
    truth = stt.surface_scene(n, seed=0, device=device)
    cams = stt.orbit_trajectory(
        stt.Camera.create(h=300, w=400, position=(0.0, -1.0, 3.5),
                          device=device), 4, yaw_sweep=0.8, pitch_sweep=0.2)
    cfg = stt.RenderConfig(max_dup_factor=3.0)
    targets = torch.stack([stt.render_dense(truth, c, cfg, chunk=64)
                           for c in cams])
    rng = np.random.default_rng(1)
    jitter = torch.tensor(rng.normal(0.0, 0.02, (n, 3)).astype(np.float32),
                          device=device)
    start = dataclasses.replace(
        truth, means=truth.means + jitter, sh=truth.sh * 0.6,
        opacities=torch.clamp(truth.opacities * 0.8, 0.01, 0.99))
    t0 = time.perf_counter()
    res = stt.fit(start, cams, targets, steps=FIT_STEPS, lr=5e-3,
                  config=cfg, method="tiled", l1_weight=0.2,
                  dssim_weight=0.2)
    secs = time.perf_counter() - t0
    losses = res.losses.cpu()
    require(losses.shape == (FIT_STEPS,) and bool(torch.isfinite(
        losses).all()), "fitted-20k recipe: non-finite losses")
    first, last = float(losses[0]), float(losses[-1])
    require(last < first / 2,
            f"fitted-20k recipe: loss {first} -> {last}, not halved")
    print(f"[train] fitted_20k recipe @400x300, 4 views, {FIT_STEPS} tiled "
          f"steps (L2 + L1 + D-SSIM, lr 5e-3): loss {first:.6f} -> "
          f"{last:.6f} ({first / last:.2f}x lower) in {secs:.2f} s")
    del truth, start, res, targets

    truth = stt.surface_scene(N_BIG, seed=0, device=device)
    cams = stt.orbit_trajectory(
        stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0),
                          device=device), 2, yaw_sweep=0.05)
    cfg = stt.RenderConfig(max_dup_factor=1.45)
    targets = torch.stack([stt.render(truth, c, cfg) for c in cams])
    start = dataclasses.replace(truth, sh=truth.sh * 0.8)
    del truth
    k_cap = int(cfg.max_dup_factor * N_BIG)

    def demand(scene):
        with torch.no_grad():
            return max(int(count_pairs(project_gaussians(scene, c, cfg),
                                       H, W, cfg)[1]) for c in cams)

    def run(steps):
        return stt.fit(start, cams, targets, steps=steps, lr=5e-3,
                       config=cfg, method="tiled", l1_weight=0.2,
                       dssim_weight=0.2)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(1)                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        t_start.record()
        res = run(BIG_FIT_STEPS)
        t_end.record()
        torch.cuda.synchronize()
    truncated = [str(w.message) for w in caught
                 if str(w.message).startswith("fit:")]
    require(not truncated, f"1M fit: {truncated}")
    ms = t_start.elapsed_time(t_end) / BIG_FIT_STEPS
    pairs = max(demand(start), demand(res.scene))
    overflow = max(pairs - k_cap, 0)
    require(overflow == 0, f"1M fit: {pairs} pairs > k_cap {k_cap}")
    losses = res.losses.cpu()
    require(bool(torch.isfinite(losses).all()), "1M fit: non-finite loss")
    print(f"[train] surface {N_BIG} @{W}x{H}, 2 views, dup "
          f"{cfg.max_dup_factor}: {ms:.3f} ms/step ({BIG_FIT_STEPS} steps "
          f"of fit() timed whole with CUDA events, set-up included); "
          f"loss {float(losses[0]):.6f} -> {float(losses[-1]):.6f}; "
          f"pairs<={pairs} k_cap={k_cap} overflow={overflow}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def run_cli(argv):
    """``python -m splat_tpu_torch`` in this process; echoes its output
    and returns (stdout, stderr).  Any failure raises."""
    import contextlib
    import io
    from splat_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    for line in out.getvalue().splitlines():
        print(f"[cli {argv[0]}] {line}")
    require(rc == 0, f"cli {argv[0]} returned {rc}")
    return out.getvalue(), err.getvalue()


def rotmat_to_qvec(r):
    """Scalar-first unit quaternion of a 3x3 rotation (Shepperd)."""
    import numpy as np
    r = np.asarray(r, np.float64)
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = [(r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s,
             (r[0, 2] + r[2, 0]) / s]
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s,
             (r[1, 2] + r[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
             (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    return [float(x) for x in q]


def se3_camera_file(path: str, h: int, w: int) -> None:
    """A camera file of four rolled SE(3) views around the fitted scene's
    pose, view_matrix and COLMAP qvec/tvec forms mixed, fx != fy and an
    off-centre principal point."""
    import numpy as np
    import splat_tpu_torch as stt
    views = []
    for i, (pos, roll) in enumerate((((0.0, -1.0, 3.5), 0.25),
                                     ((0.6, -1.1, 3.3), -0.2),
                                     ((-0.5, -0.8, 3.6), 0.1),
                                     ((0.2, -1.4, 3.2), -0.05))):
        v = stt.Camera.create(h=h, w=w, position=pos, device="cpu")
        v = v.view_matrix().double().numpy()
        c, s = math.cos(roll), math.sin(roll)
        r = np.eye(4)
        r[:2, :2] = [[c, -s], [s, c]]
        v = r @ v
        if i % 2:       # COLMAP: y down, z forward
            flip = np.diag([1.0, -1.0, -1.0])
            views.append({"qvec": rotmat_to_qvec(flip @ v[:3, :3]),
                          "tvec": (flip @ v[:3, 3]).tolist()})
        else:
            views.append({"view_matrix": v.tolist()})
    focal = h / 2.0        # fovy 90 degrees
    with open(path, "w") as f:
        json.dump({"h": h, "w": w, "fx": focal * 1.15, "fy": focal,
                   "cx": w * 0.47, "cy": h * 0.53, "views": views}, f)


def cli_and_viewer(device, kernels) -> dict:
    """Phase 8: the command line and the viewer on the card, in process.
    Returns each kernel's launches on the inference commands (render,
    orbit, bench, the viewer) and on ``fit``."""
    import statistics
    import tempfile
    import threading
    import urllib.request
    import numpy as np
    import torch
    import splat_tpu_torch as stt
    from splat_tpu_torch import cli
    from splat_tpu_torch.io.cache import load_scene_cached
    from splat_tpu_torch.native.loader import load_ply_native
    from splat_tpu_torch.render.api import frame_fn
    from splat_tpu_torch.utils.image import read_png, write_png
    from splat_tpu_torch.viewer.server import make_server

    expand, raster, fwd, bwd, front = kernels
    dev = ["--device", "cuda"]
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        # ---- load: native against NumPy, then the npz cache
        ply = os.path.join(tmp, "surface_1m.ply")
        scene, _ = bench_scene("surface", N_BIG, device)
        stt.save_ply(ply, scene)
        del scene
        mb = os.path.getsize(ply) / 1e6
        t0 = time.perf_counter()
        nat = load_ply_native(ply, center=True, device=device)
        torch.cuda.synchronize()
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = stt.load_ply(ply, center=True, native=False, device=device)
        torch.cuda.synchronize()
        t_numpy = time.perf_counter() - t0
        a, b = nat.to_numpy(), ref.to_numpy()
        for k in ("means", "quats", "sh"):
            require(np.array_equal(a[k], b[k]), f"native {k} differs from "
                                                f"the NumPy reader")
        # glibc's expf and NumPy's exp round up to 2 ulp apart (tests/
        # test_torch_io.py): the exp-activated fields at rtol 1e-6
        for k in ("scales", "opacities"):
            rel = float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k])))
            require(rel <= 1e-6, f"native {k}: rel error {rel} > 1e-6")
        del ref, b
        load_scene_cached(ply, device=device)       # writes the cache
        t0 = time.perf_counter()
        scene = load_scene_cached(ply, device=device)
        torch.cuda.synchronize()
        t_cache = time.perf_counter() - t0
        c = scene.to_numpy()
        require(all(np.array_equal(a[k], c[k]) for k in a),
                "warm cache differs from the native load")
        del nat, a, c
        print(f"[load] {N_BIG} surface gaussians, {mb:.1f} MB PLY: native "
              f"{t_native * 1e3:.1f} ms, NumPy {t_numpy * 1e3:.1f} ms "
              f"({t_numpy / t_native:.1f}x), warm npz cache "
              f"{t_cache * 1e3:.1f} ms (to the card)")

        out, _ = run_cli(["info", ply, *dev])
        require(json.loads(out)["num_gaussians"] == N_BIG, "info: count")

        # ---- render: the CLI's PNG against stt.render, same inputs
        zero_launches(kernels)
        png = os.path.join(tmp, "render.png")
        _, err = run_cli(["render", ply, "--size", f"{W}x{H}", "--pos",
                          "0,0,4", "--dup-factor", "auto", "--stats",
                          "--out", png, *dev])
        stats = json.loads(err.strip().splitlines()[-1])
        require(stats["overflow"] == 0, f"render --stats: {stats}")
        cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0),
                                device=device)
        dup = stt.pair_stats(scene, cam)["suggested_dup_factor"]
        cfg = stt.RenderConfig(max_dup_factor=dup)
        counts = saved_launches(kernels)
        want = stt.render(scene, cam, cfg, as_uint8=True).cpu().numpy()
        restore_launches(counts)             # the reference is not the path
        diff = int(np.abs(read_png(png).astype(int) - want).max())
        require(diff <= 1, f"render PNG vs stt.render: max abs {diff} > 1")
        print(f"[cli render] PNG vs stt.render: max abs {diff} (u8); "
              f"--stats {stats}")

        # ---- orbit --path: SE(3) views of the fitted scene
        fitted = os.path.join(tmp, "fitted_20k.ply")
        with open(FITTED_PLY, "rb") as fsrc, open(fitted, "wb") as fdst:
            fdst.write(fsrc.read())
        cams_json = os.path.join(tmp, "cams.json")
        se3_camera_file(cams_json, 300, 400)
        frames = os.path.join(tmp, "se3")
        _, err = run_cli(["orbit", fitted, "--no-center", "--path",
                          cams_json, "--out-dir", frames, *dev])
        require("WARNING" not in err, f"orbit --path: {err}")
        fscene = load_scene_cached(fitted, center=False, device=device)
        se3, _, _ = cli._load_camera_path(cams_json, "800x600", 90.0,
                                          device=device)
        ps = []
        for i, c in enumerate(se3):
            got = read_png(os.path.join(frames, f"frame_{i:04d}.png"))
            ref = stt.render_dense(fscene, c, chunk=64)
            ps.append(stt.psnr(got.astype(np.float32) / 255.0, ref))
        require(min(ps) >= FITTED_MIN_PSNR,
                f"orbit --path vs render_dense: {ps} dB")
        print(f"[cli orbit --path] {len(se3)} SE(3) views @400x300 vs "
              f"render_dense: {', '.join(f'{p:.2f}' for p in ps)} dB")

        # ---- orbit of the 1M surface PLY and bench, at 1080p
        out, err = run_cli(["orbit", ply, "--size", f"{W}x{H}", "--pos",
                            "0,0,4", "--frames", str(ORBIT_FRAMES),
                            "--yaw-sweep", "10", "--png-level", "0",
                            "--out-dir", os.path.join(tmp, "orbit"), *dev])
        require("WARNING" not in err, f"orbit: {err}")
        orbit_ms = float(out.split(" ms/frame")[0].split()[-1])
        out, err = run_cli(["bench", "--n", str(N_BIG), "--size",
                            f"{W}x{H}", "--frames", "30", *dev])
        require("WARNING" not in err and " overflow=0 " in out,
                f"bench: overflow ({err})")
        bench_ms = float(out.split(" ms/frame")[0].split()[-1])

        # ---- the viewer, serving the 1M surface scene at 1080p
        srv = make_server(scene, cam, cfg, port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def get(q):
            t0 = time.perf_counter()
            with urllib.request.urlopen(base + q, timeout=300) as r:
                body, hdr = r.read(), dict(r.headers)
            return body, hdr, (time.perf_counter() - t0) * 1e3

        try:
            page, _, _ = get("/")
            require(b"splat_tpu viewer" in page, "viewer: no page")
            checks = [("/frame.raw?yaw=0", W, H),
                      ("/frame.raw?yaw=0.3", W, H),
                      ("/frame.raw?yaw=-0.3", W, H),
                      ("/frame.raw?mode=depth", W, H),
                      ("/frame.png?yaw=0.1", W, H),
                      ("/frame.raw?scale=0.5", W // 2, H // 2),
                      ("/frame.raw?scale=2.0", 2 * W, 2 * H)]
            for q, w, h in checks:
                body, hdr, _ = get(q)
                require(hdr["X-Splat-Overflow"] == "0", f"viewer {q}: "
                        f"overflow {hdr['X-Splat-Overflow']}")
                require((int(hdr["X-Splat-W"]), int(hdr["X-Splat-H"]))
                        == (w, h), f"viewer {q}: size")
                if q.startswith("/frame.raw"):
                    require(len(body) == w * h * 4, f"viewer {q}: bytes")
                else:
                    require(body[:8] == b"\x89PNG\r\n\x1a\n", "viewer: png")
                if q == "/frame.raw?yaw=0":
                    frame = np.frombuffer(body, np.uint8).reshape(h, w, 4)
                    diff = int(np.abs(frame[..., :3].astype(int)
                                      - want).max())
                    require(diff <= 1, f"viewer frame vs render: {diff}")
            times = [get(f"/frame.raw?yaw={0.02 * i}")[2]
                     for i in range(VIEWER_REQUESTS)]
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=60)
        require(not th.is_alive(), "viewer thread did not stop")
        viewer_ms = statistics.median(times)
        inference = {"K1": expand.launches, "K2": raster.launches,
                     "K3": fwd.launches, "K4": bwd.launches,
                     **front_launches(front)}
        saved = saved_launches(kernels)
        # the same poses without the server: what a request spends in the
        # render (the viewer's compiled frame), the overflow read and the
        # copy to the host (not counted)
        frame = frame_fn("tiled", cfg, return_stats=True)
        frame_ms = []
        for i in range(VIEWER_REQUESTS):
            c = cam.with_pose(yaw=0.02 * i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                img, st = frame(scene.pack_device(), c)
                int(st["overflow"])
                (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(
                    torch.uint8).cpu().numpy()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        restore_launches(saved)
        print(f"[viewer] {N_BIG} surface @{W}x{H}: raw/png/depth/0.5x/2.0x "
              f"served with overflow 0, first raw frame = render (max abs "
              f"{diff}); pose->bytes median {viewer_ms:.1f} ms over "
              f"{VIEWER_REQUESTS} raw requests (min {min(times):.1f}, max "
              f"{max(times):.1f}); the same poses' render + overflow read + "
              f"copy to host alone: median "
              f"{statistics.median(frame_ms):.1f} ms")
        del scene

        # ---- fit --targets/--cameras with the SE(3) views
        tdir = os.path.join(tmp, "targets")
        os.makedirs(tdir)
        for i, c in enumerate(se3):
            write_png(os.path.join(tdir, f"view_{i}.png"),
                      stt.render_dense(fscene, c, chunk=64))
        rng = np.random.default_rng(1)
        n = fscene.num_gaussians
        jitter = torch.tensor(rng.normal(0.0, 0.02, (n, 3))
                              .astype(np.float32), device=device)
        start = dataclasses.replace(
            fscene, means=fscene.means + jitter, sh=fscene.sh * 0.6,
            opacities=torch.clamp(fscene.opacities * 0.8, 0.01, 0.99))
        init = os.path.join(tmp, "init.ply")
        stt.save_ply(init, start)
        zero_launches(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = run_cli(["fit", "--targets", tdir, "--cameras", cams_json,
                          "--init", init, "--steps", str(FIT_STEPS),
                          "--fit-method", "tiled", "--out",
                          os.path.join(tmp, "fit.ply"), *dev])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        line = next(s for s in out.splitlines() if s.startswith("fit in"))
        first, last = (float(x) for x in
                       line.split("loss ")[1].split(" (")[0].split(" -> "))
        require(last < first / 2, f"fit: loss {first} -> {last}, not "
                                  f"halved")
        training = {"K1": expand.launches, "K2": raster.launches,
                    "K3": fwd.launches, "K4": bwd.launches,
                    **front_launches(front)}
        print(f"[cli fit] {len(se3)} SE(3) views @400x300, {FIT_STEPS} "
              f"tiled steps from a perturbed fitted_20k: loss {first:.5f} "
              f"-> {last:.5f}; {fit_s * 1e3 / FIT_STEPS:.2f} ms/step "
              f"(whole command / steps: load, capacity audit, final PSNR "
              f"renders and PLY write included)")
    require(inference["K1"] > 0 and inference["K2"] > 0,
            f"K1/K2 did not launch on render/orbit/bench/serve: {inference}")
    # the front end once a frame, as K1
    require(inference["front"] == inference["K1"],
            f"the front end's frames differ from K1's: {inference}")
    require(training["K3"] > 0 and training["K4"] > 0,
            f"K3/K4 did not launch on fit: {training}")
    # fit's capacity audit and each step's demand pass, count-only once a
    # view; the final PSNR renders size their capacity once (count-only)
    # and capture once (its warm-up a frame more than the views)
    v = len(se3)
    want = {"front": v + 1, "front_count": v * (FIT_STEPS + 1) + 1}
    require({k: training[k] for k in want} == want,
            f"the front end on fit: {training}, not {want}")
    print(f"[cli] launches on render/orbit/bench/serve: {inference}; on "
          f"fit: {training}")
    print(json.dumps({"cli": {
        "native_load_ms": t_native * 1e3, "numpy_load_ms": t_numpy * 1e3,
        "cache_load_ms": t_cache * 1e3, "orbit_ms_per_frame": orbit_ms,
        "bench_ms_per_frame": bench_ms, "viewer_pose_to_bytes_ms": viewer_ms,
        "viewer_render_and_copy_ms": statistics.median(frame_ms),
        "fit_ms_per_step": fit_s * 1e3 / FIT_STEPS}}))
    return {"inference": inference, "fit": training}


def card_links(world: int) -> str:
    """The link between card 0 and each other card, from ``nvidia-smi
    topo -m`` (its matrix printed too); where that fails, card 0's NVLink
    links (``nvidia-smi nvlink --status``) and peer access."""
    import re
    import torch
    if world < 2:
        return "one card"

    def smi(*args) -> str:
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True)
        return re.sub(r"\x1b\[[0-9;]*m", "", out.stdout + out.stderr)

    topo = smi("topo", "-m")
    for line in topo.splitlines():
        print(f"[topo] {line}")
    rows = [line.split() for line in topo.splitlines()
            if line.startswith("GPU0")]
    if rows and len(rows[0]) > world:
        return ", ".join(f"GPU0-GPU{k} {rows[0][1 + k]}"
                         for k in range(1, world))
    links = [line.strip() for line in smi("nvlink", "--status",
                                          "-i", "0").splitlines()
             if "GB/s" in line]
    for line in links:
        print(f"[nvlink] GPU0 {line}")
    peer = all(torch.cuda.can_device_access_peer(0, k)
               for k in range(1, world))
    return (f"GPU0: {len(links)} NVLink links up"
            f"{' (' + links[0] + ')' if links else ''}; peer access to "
            f"GPU1-{world - 1}: {peer} (topo -m failed)")


def kernel_errors(proj, h: int, w: int, cfg) -> dict:
    """K1-K4 against their plain versions on one frame, on the device of
    ``proj``: K1's keys and owners equal, K2's and K3's max abs errors,
    K3's cut equal, K4's worst per-field error relative to the field's
    largest value and its cosine."""
    import torch
    from splat_tpu_torch.render import binning, diff
    from splat_tpu_torch.render.expand import expand_pair_keys_plain
    from splat_tpu_torch.render.kernels import (rasterize_tiles,
                                                rasterize_tiles_plain)

    lay = binning.slot_layout(proj, h, w, cfg)
    keys, owners = lay.expand()
    keys_p, owners_p = lay.expand(expand_pair_keys_plain)
    bins = binning.build_tile_bins(proj, h, w, cfg)
    img = rasterize_tiles(bins, h, w, cfg)
    img_p = rasterize_tiles_plain(bins, h, w, cfg)
    c, lt, cut = diff.rasterize_train_fwd(bins, h, w, cfg)
    c_p, lt_p, cut_p = diff.rasterize_train_fwd_plain(bins, h, w, cfg)
    gen = torch.Generator(device=c.device).manual_seed(0)
    g_c = torch.randn((h, w, 3), generator=gen, device=c.device)
    g_lt = torch.randn((h, w), generator=gen, device=c.device)
    g = diff.rasterize_train_bwd(bins, g_c, g_lt, lt, cut, h, w, cfg)
    g_p = diff.rasterize_train_bwd_plain(bins, g_c, g_lt, lt, cut, h, w, cfg)
    a, b = g.double().flatten(), g_p.double().flatten()
    return {
        "pairs": int(bins.num_pairs), "overflow": int(bins.overflow),
        "K1_equal": bool(torch.equal(keys, keys_p)
                         and torch.equal(owners, owners_p)),
        "K2_err": float((img - img_p).abs().max()),
        "K3_err": max(float((c - c_p).abs().max()),
                      float((lt - lt_p).abs().max())),
        "K3_cut_equal": bool(torch.equal(cut, cut_p)),
        "K4_rel": max(float((g[:, q] - g_p[:, q]).abs().max())
                      / (float(g_p[:, q].abs().max()) + 1e-30)
                      for q in range(g.shape[1])),
        "K4_cos": float(a @ b / (a.norm() * b.norm())),
        "finite": bool(torch.isfinite(img).all() & torch.isfinite(c).all()
                       & torch.isfinite(g).all())}


def parallel_rank(rank: int, world: int, dev, sizes: dict) -> dict:
    """Phase 9 on one rank of a world of ``world`` ranks, one a card
    (every rank runs this, making the same collective calls in the same
    order).  ``sizes`` (``PARALLEL_SIZES`` on the card): the scene size
    ``n`` a card (the frames' capacity ``dup``, None: ``bench_scene``'s),
    the frame ``h`` x ``w``, ``frames`` yaw views, fit
    ``steps`` at ``fit_dup`` (phase 6's recipe), the ``slab_ways`` of the in-process split, the kernel
    check's scene (``check_ply``, else ``surface_scene(check_n)``) and
    frame ``check_h`` x ``check_w``; ``fail_rank`` makes that rank raise
    once the world is up (the launcher's failure test).

    Measures and returns; :func:`check_parallel` in the launching
    process holds the results of every rank to the phase's limits.  Rank
    0 also computes the single-card references (``render_tiled`` of the
    whole scene, two single-card ``fit`` runs) while the others wait in
    their next collective.  Launches are counted from 0 before each path
    and read after it."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import splat_tpu_torch as stt
    from splat_tpu_torch.ops.projection import project_gaussians
    from splat_tpu_torch.parallel import sharding
    from splat_tpu_torch.render.diff import (rasterize_train_bwd,
                                             rasterize_train_fwd)
    from splat_tpu_torch.render.expand import expand_pair_keys
    from splat_tpu_torch.render.kernels import rasterize_tiles

    kernels = {"K1": expand_pair_keys, "K2": rasterize_tiles,
               "K3": rasterize_train_fwd, "K4": rasterize_train_bwd}
    n, h, w, frames, steps = (sizes[k] for k in ("n", "h", "w", "frames",
                                                 "steps"))
    on_card = dev.type == "cuda"
    lead = rank == 0
    out: dict = {"rank": rank, "device": str(dev), "launches": {},
                 "frames": {}, "batch": {}, "slab_split": {}, "fits": {}}

    def local_sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def sync():
        dist.all_reduce(torch.zeros(1, device=dev))
        local_sync()

    def clock(fn, reps: int, warmup: bool = True) -> float:
        """ms per call of ``fn(i)``, i < reps (after a warm-up call): CUDA
        events on the card, the host clock on the CPU."""
        if warmup:
            fn(0)
        local_sync()
        if on_card:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for i in range(reps):
                fn(i)
            t1.record()
            local_sync()
            return t0.elapsed_time(t1) / reps
        t = time.perf_counter()
        for i in range(reps):
            fn(i)
        return (time.perf_counter() - t) * 1e3 / reps

    def slowest(fn, reps: int, warmup: bool = True) -> float:
        """``clock`` between syncs of every rank; the slowest rank's."""
        sync()
        t = torch.tensor([clock(fn, reps, warmup)], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def counted(path: str, run):
        for k in kernels.values():
            k.launches = 0
        res = run()
        local_sync()
        out["launches"][path] = {k: fn.launches for k, fn in kernels.items()}
        return res

    def image_stats(img, ref) -> dict:
        """The spread of ``img`` over the ranks (0: every rank holds the
        same image), and on rank 0 the slab limits' figures against the
        single-card ``ref``."""
        lo, hi = img.clone(), img.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        st = {"shape": list(img.shape), "spread": float((hi - lo).max()),
              "finite": bool(torch.isfinite(img).all())}
        if ref is not None:
            st["psnr"] = float(stt.psnr(img, ref))
            st["share_off"] = float(((img - ref).abs() > 1e-6).float().mean())
        return st

    mesh_g = sharding.make_mesh(1, world, device=dev.type)
    mesh_d = sharding.make_mesh(world, 1, device=dev.type)
    batch_meshes = {f"{world}x1": mesh_d}
    if world == 4:
        batch_meshes["2x2"] = sharding.make_mesh(2, 2, device=dev.type)
    if rank == sizes.get("fail_rank"):
        raise RuntimeError(f"rank {rank} fails on purpose")

    # ---- K1-K4 against their plain versions on this rank's card
    if sizes.get("check_ply"):
        small = stt.load_ply(sizes["check_ply"], center=False, device=dev)
    else:
        small = stt.surface_scene(sizes["check_n"], seed=0, device=dev)
    ch, cw = sizes["check_h"], sizes["check_w"]
    ccam = stt.Camera.create(h=ch, w=cw, position=(0.0, -1.0, 3.5),
                             device=dev)
    ccfg = stt.RenderConfig(max_dup_factor=3.0)
    out["kernels"] = kernel_errors(project_gaussians(
        small.pack_device(), ccam, ccfg), ch, cw, ccfg)
    del small

    # ---- frames on (1, N): gaussians over 'g', both routes
    cam = stt.Camera.create(h=h, w=w, position=(0.0, 0.0, 4.0), device=dev)
    views = stt.stack_cameras([cam.rotate(0.01 * i) for i in range(frames)])
    h_local = h // world
    for kind, n_scene in (("random", n), ("surface", n),
                          ("random_weak", world * n)):
        scene, dup = bench_scene(kind.split("_")[0], n_scene, dev)
        cfg = stt.RenderConfig(max_dup_factor=sizes.get("dup") or dup)
        local = sharding.shard_scene(scene, mesh_g)
        fig: dict = {"n": n_scene, "n_local": local.num_gaussians}
        refs = [None] * frames
        if lead:                # the batch below holds every view
            refs = [stt.render_tiled(scene, v, cfg, return_stats=True)
                    for v in (views if kind == "surface" else views[:1])]
            fig["ref_overflow"] = sum(int(st["overflow"]) for _, st in refs)
            refs = [img for img, _ in refs]
        imgs = {}
        for route in ("gather", "a2a"):
            img, ov = counted(f"{kind}_{route}", lambda route=route:
                              sharding.render_sharded_tiled(
                                  local, cam, mesh_g, cfg, route=route))
            st = image_stats(img, refs[0])
            st["overflow"] = int(ov)
            if kind != "random_weak":
                plocal = sharding.shard_scene(scene.pack_device(), mesh_g)
                pimg, pov = counted(
                    f"{kind}_{route}_packed", lambda route=route:
                    sharding.render_sharded_tiled(plocal, cam, mesh_g, cfg,
                                                  route=route))
                st["packed_equal"] = bool(torch.equal(pimg, img)
                                          and int(pov) == 0)
                del plocal, pimg
            st["ms_per_frame"] = slowest(
                lambda i, route=route: sharding.render_sharded_tiled(
                    local, views[i], mesh_g, cfg, route=route), frames)
            imgs[route] = img
            fig[route] = st
        fig["a2a_vs_gather"] = float((imgs["a2a"] - imgs["gather"]).abs()
                                     .max())
        # bytes each rank receives from the other ranks per frame
        cap = sharding.slab_cap(local.num_gaussians,
                                sharding._auto_cap_factor(
                                    local, world, sharding._axis(
                                        mesh_g, "g")[0]))
        rec = sharding.RECORD_ROWS * 4
        fig["bytes_per_frame"] = {
            "record_gather": (world - 1) * local.num_gaussians * rec,
            "a2a_records_and_mask": (world - 1) * cap * (rec + 4),
            "slab_gather": (world - 1) * h_local * w * 3 * 4}
        if lead:
            fig["render_tiled_ms_per_frame"] = clock(
                lambda i: stt.render_tiled(scene, views[i], cfg), frames)
        if kind == "surface":
            # ---- batches on (N, 1) (and (2, 2)): frames over 'd'
            single_ms = fig.get("render_tiled_ms_per_frame")
            for name, mesh in batch_meshes.items():
                blocal = sharding.shard_scene(scene, mesh)
                bimgs, ov = counted(f"batch_{name}", lambda: (
                    sharding.render_batch_sharded_tiled(blocal, views, mesh,
                                                        cfg)))
                sts = [image_stats(bimgs[i], refs[i]) for i in range(frames)]
                out["batch"][name] = {
                    "overflow": int(ov),
                    "spread": max(s["spread"] for s in sts),
                    "finite": all(s["finite"] for s in sts),
                    "psnr_min": min(s.get("psnr", math.inf) for s in sts),
                    "share_off_max": max(s.get("share_off", 0.0)
                                         for s in sts),
                    "ms_per_frame": slowest(
                        lambda i: sharding.render_batch_sharded_tiled(
                            blocal, views, mesh, cfg), 1, False) / frames,
                    "render_tiled_ms_per_frame": single_ms}
                del blocal, bimgs
            if lead:
                # ---- the row slabs of an in-process split, stitched
                proj = project_gaussians(scene, cam, cfg)
                for ways in sizes["slab_ways"]:
                    rows = h // ways
                    parts = counted(f"slab_split_{ways}way", lambda ways=ways,
                                    rows=rows: [sharding.render_slab_tiled(
                                        proj, g * rows, rows, w, cfg)
                                        for g in range(ways)])
                    got = torch.cat([p for p, _ in parts])
                    out["slab_split"][str(ways)] = {
                        "rows": rows,
                        "overflow": sum(int(o) for _, o in parts),
                        "finite": bool(torch.isfinite(got).all()),
                        "psnr": float(stt.psnr(got, refs[0])),
                        "share_off": float(((got - refs[0]).abs() > 1e-6)
                                           .float().mean())}
                del proj, parts, got
        out["frames"][kind] = fig
        del scene, local, refs, imgs, img
    # ---- fit(mesh=): TP over 'g' on (1, N) with 2 views, DP over 'd' on
    # (N, 1) with one view a rank
    truth = stt.surface_scene(n, seed=0, device=dev)
    fcfg = stt.RenderConfig(max_dup_factor=sizes["fit_dup"])
    start = dataclasses.replace(truth, sh=truth.sh * 0.8)
    for name, mesh, n_views in ((f"tp_1x{world}", mesh_g, 2),
                                (f"dp_{world}x1", mesh_d, world)):
        fcams = stt.orbit_trajectory(cam, n_views, yaw_sweep=0.05)
        targets = torch.stack([stt.render(truth, c, fcfg) for c in fcams])

        def run(k, **kw):
            return stt.fit(start, fcams, targets, steps=k, lr=5e-3,
                           config=fcfg, method="tiled", l1_weight=0.2,
                           dssim_weight=0.2, **kw)

        fig = {"views": n_views, "local_views": len(
            sharding._local_frames(fcams, mesh))}
        if lead:
            # two single-card runs (they differ by K4's atomic adds), the
            # first the second's warm-up
            singles = [run(steps)]
            fig["single_ms_per_step"] = clock(
                lambda i: singles.append(run(steps)), 1, False) / steps
            fig["single_losses"] = [s.losses.cpu().tolist() for s in singles]
        run(1, mesh=mesh)                                # warm-up
        res = []
        fig["ms_per_step"] = counted(f"fit_{name}", lambda: slowest(
            lambda i: res.append(run(steps, mesh=mesh)), 1, False)) / steps
        fit = res[-1]
        fig["losses"] = fit.losses.cpu().tolist()
        whole = [getattr(fit.scene, f.name) for f in
                 dataclasses.fields(fit.scene)]
        fig["whole_n"] = fit.scene.num_gaussians
        fig["whole_finite"] = all(bool(torch.isfinite(t).all())
                                  for t in whole)
        fig["whole_moved"] = max(float((a - b).abs().max()) for a, b in zip(
            whole, (getattr(start, f.name) for f in
                    dataclasses.fields(start))))
        out["fits"][name] = fig
        del targets, res, fit, whole
    del truth, start
    return out


def check_parallel(results: list, sizes: dict, on_card: bool) -> dict:
    """Hold every rank's results from :func:`parallel_rank` to phase 9's
    limits (any miss raises) and return the phase's figures.

    A sharded fit's loss history must lie within ``tol = max(
    FIT_LOSS_RTOL, FIT_GAP_FACTOR * gap)`` (relative, every step) of the
    nearer of two single-card runs, ``gap`` being those two runs' own
    relative difference: across cards the gradients are summed in another
    order (the reduce-scatter of the record cotangents, the average over
    'd'), a rounding of the same kind as K4's run-dependent atomic adds
    that make ``gap``."""
    import numpy as np

    world = len(results)
    lead = results[0]
    for r, res in enumerate(results):
        who = f"rank {r} ({res['device']})"
        k = res["kernels"]
        require(k["finite"] and k["overflow"] == 0,
                f"{who}: kernel check frame non-finite or overflowing")
        require(k["K1_equal"], f"{who}: K1 differs from its plain version")
        require(k["K2_err"] <= K2_TOL, f"{who}: K2 max abs error "
                                       f"{k['K2_err']} > {K2_TOL}")
        require(k["K3_err"] <= K3_TOL and k["K3_cut_equal"],
                f"{who}: K3 max abs error {k['K3_err']} > {K3_TOL} or its "
                f"cut differs")
        require(k["K4_rel"] <= K4_REL_TOL and k["K4_cos"] >= K4_MIN_COS,
                f"{who}: K4 per-field error {k['K4_rel']}, cosine "
                f"{k['K4_cos']}")
        for path, got in res["launches"].items():
            if not on_card:         # plain versions only: nothing counts
                require(not any(got.values()),
                        f"{who}: {path} counted launches on the CPU: {got}")
            elif path.startswith("fit_"):
                fig = res["fits"][path[4:]]
                want = fig["local_views"] * sizes["steps"]
                require(got["K3"] == got["K4"] == want,
                        f"{who}: {path} launched K3/K4 {got['K3']}/"
                        f"{got['K4']} times, not once a local view and "
                        f"step ({want})")
            else:
                require(got["K1"] > 0 and got["K2"] > 0,
                        f"{who}: K1/K2 did not launch on {path}: {got}")
        for kind, fig in res["frames"].items():
            require(fig.get("ref_overflow", 0) == 0,
                    f"{who}: {kind}'s single-card references overflow")
            for route in ("gather", "a2a"):
                st = fig[route]
                what = f"{who}: {kind} {fig['n']} on (1, {world}) {route}"
                require(st["overflow"] == 0, f"{what}: overflow "
                                             f"{st['overflow']}")
                require(st["finite"] and st["spread"] == 0.0,
                        f"{what}: non-finite, or ranks hold images "
                        f"{st['spread']} apart")
                require(st.get("packed_equal", True),
                        f"{what}: the packed shard's image differs")
                if "psnr" in st:
                    require(st["psnr"] >= SLAB_MIN_PSNR
                            and st["share_off"] < SLAB_MAX_DIFF_SHARE,
                            f"{what}: {st['psnr']:.2f} dB, "
                            f"{st['share_off']:.5f} of pixels off > 1e-6 "
                            f"against one card's render_tiled")
            require(fig["a2a_vs_gather"] <= A2A_GATHER_TOL,
                    f"{who}: {kind} a2a differs from gather by "
                    f"{fig['a2a_vs_gather']}")
        for name, st in res["batch"].items():
            what = f"{who}: batch on ({name.replace('x', ', ')})"
            require(st["overflow"] == 0 and st["finite"]
                    and st["spread"] == 0.0,
                    f"{what}: overflow {st['overflow']}, or non-finite, or "
                    f"ranks hold images {st['spread']} apart")
            require(st["psnr_min"] >= SLAB_MIN_PSNR
                    and st["share_off_max"] < SLAB_MAX_DIFF_SHARE,
                    f"{what}: {st['psnr_min']:.2f} dB, "
                    f"{st['share_off_max']:.5f} of pixels off > 1e-6")
        for name, fig in res["fits"].items():
            require(fig["losses"] == lead["fits"][name]["losses"],
                    f"{who}: fit {name}'s losses differ from rank 0's")
            require(fig["whole_n"] == sizes["n"] and fig["whole_finite"]
                    and fig["whole_moved"] > 0,
                    f"{who}: fit {name}'s whole parameters: "
                    f"{fig['whole_n']} gaussians, finite "
                    f"{fig['whole_finite']}, moved {fig['whole_moved']}")
    for ways, st in lead["slab_split"].items():
        require(st["overflow"] == 0 and st["finite"]
                and st["psnr"] >= SLAB_MIN_PSNR
                and st["share_off"] < SLAB_MAX_DIFF_SHARE,
                f"{ways}-way slab split ({st['rows']} rows): overflow "
                f"{st['overflow']}, {st['psnr']:.2f} dB, "
                f"{st['share_off']:.5f} of pixels off > 1e-6")

    def rel_diff(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.abs(b)))

    fits = {}
    for name, fig in lead["fits"].items():
        singles = fig["single_losses"]
        require(all(np.isfinite(s).all() for s in singles + [fig["losses"]]),
                f"fit {name}: non-finite loss")
        gap = rel_diff(*singles)
        tol = max(FIT_LOSS_RTOL, FIT_GAP_FACTOR * gap)
        rel = min(rel_diff(fig["losses"], s) for s in singles)
        require(rel <= tol, f"fit {name}: losses {fig['losses']} against "
                            f"single-card {singles}: {rel:.3e} relative > "
                            f"{tol:.3e}")
        fits[name] = {**fig, "single_run_to_run_rel_diff": gap,
                      "max_rel_loss_diff": rel, "tolerance": tol}
    launches = {f"rank_{r}": res["launches"] for r, res in
                enumerate(results)}
    totals = {k: sum(got[k] for res in results
                     for got in res["launches"].values())
              for k in ("K1", "K2", "K3", "K4")}
    return {"world_size": world, "frames": lead["frames"],
            "batch": lead["batch"], "slab_split": lead["slab_split"],
            "fits": fits, "kernel_check": [res["kernels"] for res in results],
            "launches": launches, "launch_totals": totals,
            "packed_equal": {kind: {r: lead["frames"][kind][r][
                "packed_equal"] for r in ("gather", "a2a")}
                for kind in ("random", "surface")}}


def run_parallel_world(world: int, device: str, sizes: dict, workdir: str,
                       timeout: float) -> list:
    """Start ``world`` rank processes of this script (one a card, NCCL;
    gloo ranks on the CPU), each running :func:`parallel_rank` and writing
    its results under ``workdir``; return them in rank order.  Raises,
    with the failing rank's standard error, as soon as one rank fails, and
    when the world outlives ``timeout`` seconds."""
    from splat_tpu_torch.parallel import dryrun

    dryrun.join_ranks(dryrun.start_ranks(
        [sys.executable, os.path.abspath(__file__), "--sizes",
         json.dumps(sizes), "--out", workdir, "--timeout", str(timeout)],
        world, device, os.path.join(workdir, "store")), timeout)
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank_{r}.json")) as f:
            results.append(json.load(f))
    return results


def rank_main(argv) -> int:
    """One rank of phase 9's world (the arguments ``run_parallel_world``
    gives it)."""
    import torch.distributed as dist
    from splat_tpu_torch.parallel import dryrun

    ap = dryrun.rank_parser("one rank of chip_smoke.py's phase 9")
    ap.add_argument("--sizes", required=True, help="JSON: parallel_rank's")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    dev = dryrun.init_rank(args.rank, args.world, args.init_file,
                           args.device, args.timeout)
    try:
        res = parallel_rank(args.rank, args.world, dev,
                            json.loads(args.sizes))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.out, f"rank_{args.rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def parallel_path() -> dict:
    """Phase 9: a world of one NCCL rank a visible card.  Returns the
    phase's figures (``check_parallel``'s)."""
    import torch

    world = torch.cuda.device_count()
    link = card_links(world)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(f"[parallel] {world} card(s): {'; '.join(card)}; link: {link}")
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    torch.cuda.empty_cache()            # rank 0 shares card 0 with us
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        results = run_parallel_world(world, "cuda", PARALLEL_SIZES, tmp,
                                     PARALLEL_TIMEOUT)
    world_s = time.perf_counter() - t0
    res = check_parallel(results, PARALLEL_SIZES, on_card=True)
    t0 = time.perf_counter()
    dry = subprocess.run(
        [sys.executable, "-m", "splat_tpu_torch.parallel.dryrun", "--world",
         str(world), "--timeout", "120"], cwd=ROOT, capture_output=True,
        text=True, timeout=180)
    print(dry.stdout.strip())
    require(dry.returncode == 0, f"dryrun --world {world} exited "
                                 f"{dry.returncode}: {dry.stderr[-3000:]}")
    res.update(card=card, link=link, world_s=world_s,
               dryrun_s=time.perf_counter() - t0)
    for kind, fig in res["frames"].items():
        print(f"[parallel] {kind} {fig['n']} @{W}x{H} on (1, {world}): "
              f"gather {fig['gather']['ms_per_frame']:.3f}, a2a "
              f"{fig['a2a']['ms_per_frame']:.3f} ms/frame (slowest rank), "
              f"one card's render_tiled "
              f"{fig['render_tiled_ms_per_frame']:.3f}; "
              f"{fig['gather'].get('psnr', math.inf):.2f} / "
              f"{fig['a2a'].get('psnr', math.inf):.2f} dB; bytes a rank "
              f"receives a frame {fig['bytes_per_frame']}")
    for name, st in res["batch"].items():
        print(f"[parallel] batch of {PARALLEL_FRAMES} on ({name}): "
              f"{st['ms_per_frame']:.3f} ms/frame, one card "
              f"{st['render_tiled_ms_per_frame']:.3f}; min "
              f"{st['psnr_min']:.2f} dB")
    for name, fig in res["fits"].items():
        print(f"[parallel] fit {name}, {fig['views']} views: "
              f"{fig['ms_per_step']:.3f} ms/step, one card "
              f"{fig['single_ms_per_step']:.3f}; losses within "
              f"{fig['max_rel_loss_diff']:.3e} (tol {fig['tolerance']:.3e}"
              f", single run to run {fig['single_run_to_run_rel_diff']:.3e})")
    print(json.dumps({"parallel": res}, default=str).replace(
        "Infinity", '"inf"'))
    return res


def knob_path(device, kernels) -> tuple[dict, dict, dict]:
    """Phase 10: cull_pairs (K1's cull) and subtile_exit (K2's per-group
    exit) at the 1M random and surface frames @1920x1080.  Returns the
    kernel records of the two variants and the phase's figures."""
    import torch
    import splat_tpu_torch as stt
    from splat_tpu_torch.ops.projection import project_gaussians
    from splat_tpu_torch.parallel import sharding
    from splat_tpu_torch.render import binning, graph, plan
    from splat_tpu_torch.render.expand import expand_pair_keys_plain
    from splat_tpu_torch.render.kernels import (_ppt, rasterize_tiles,
                                                rasterize_tiles_plain)
    from splat_tpu_torch.utils.benchmark import chained_bench

    expand, raster = kernels[:2]
    cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), device=device)
    recs: dict = {}
    figures: dict = {}
    for kind in ("random", "surface"):
        scene, dup = bench_scene(kind, N_BIG, device)
        cfg = stt.RenderConfig(max_dup_factor=dup)
        cfg_c = dataclasses.replace(cfg, cull_pairs=True)
        cfg_s = dataclasses.replace(cfg, subtile_exit=True)
        proj = project_gaussians(scene, cam, cfg)
        fig: dict = {}

        # ---- K1 with the cull against its plain version, exactly
        lay_c = binning.slot_layout(proj, H, W, cfg_c)
        lay = dataclasses.replace(lay_c, cull=None)
        keys, owners = lay_c.expand()
        keys_p, owners_p = lay_c.expand(expand_pair_keys_plain)
        keys0, _ = lay.expand()
        torch.cuda.synchronize()
        require(torch.equal(keys, keys_p) and torch.equal(owners, owners_p),
                f"{kind}: K1 cull differs from its plain version")
        sentinel = (lay.tiles_x * lay.tiles_y) << 32
        kept = int((keys != sentinel).sum())
        culled = int(((keys == sentinel) & (keys0 != sentinel)).sum())
        pairs = int((keys0 != sentinel).sum())
        require(kept + culled == pairs and culled > 0,
                f"{kind}: cull kept {kept}, culled {culled} of {pairs}")
        bins_c = binning.build_tile_bins(proj, H, W, cfg_c)
        require(int(bins_c.num_pairs) == kept and int(bins_c.overflow) == 0,
                f"{kind}: num_pairs {int(bins_c.num_pairs)} != kept {kept}")
        k1_ms, k1_off_ms = cuda_ms(lay_c.expand, 20), cuda_ms(lay.expand, 20)
        k1_plain = cuda_ms(lambda: lay_c.expand(expand_pair_keys_plain), 5)
        n = lay.first_slot.shape[0]
        # K1's bytes plus the (N, 4) f32 cull rows; ~12 FP32 operations a
        # filled slot for the cull's test
        k1 = kernel_record("expand_pair_keys_cull",
                           "splat_tpu_torch/csrc/expand.cu",
                           "splat_tpu/render/expand.py:85",
                           float((keys - keys_p).abs().max()), k1_ms,
                           k1_plain, 40 * n + 8 + 16 * lay.k_cap, 12 * pairs)
        fig.update(k1_cull_ms=k1_ms, k1_ms=k1_off_ms, pairs=pairs,
                   pairs_kept=kept, pairs_culled=culled)

        # ---- the image with the cull against the one without: equal where
        # a tile walked its whole range, within alpha_min where K2's
        # whole-tile exit fell on other batch boundaries.  A tile K2 cut
        # into depth segments in either frame merges its segments' sums
        # at borders that the culled pairs move: within SEGMENT_ATOL there
        bins = binning.build_tile_bins(proj, H, W, cfg)
        split, slots = plan._split(_ppt(cfg)[0]), plan._slots(device)
        cut_tile = (plan._segments(bins.tile_start, bins.tile_end, split,
                                   slots, cfg.chunk)[1] > 0) | (
            plan._segments(bins_c.tile_start, bins_c.tile_end, split, slots,
                           cfg.chunk)[1] > 0)
        rgba = {c: stt.render_tiled(scene, cam, dataclasses.replace(
            c, alpha_channel=True)) for c in (cfg, cfg_c)}
        a0, a1 = rgba[cfg], rgba[cfg_c]
        diff_px = (a1 - a0).abs().amax(dim=-1)
        # a pixel left with T >= alpha_min kept its tile walking to the end
        open_px = (1.0 - a0[..., 3]) > cfg.alpha_min + 1e-6
        ty = torch.arange(H, device=device) // cfg.tile_h
        tx = torch.arange(W, device=device) // cfg.tile_w
        tile = ty[:, None] * lay.tiles_x + tx[None, :]
        open_tile = torch.zeros(lay.tiles_x * lay.tiles_y, dtype=torch.bool,
                                device=device)
        open_tile[tile[open_px]] = True
        whole_walk = open_tile[tile]
        cull_err = float(diff_px.max())
        require(cull_err < cfg.alpha_min, f"{kind}: cull image differs by "
                                          f"{cull_err} >= alpha_min")
        cut = cut_tile[tile]
        require(float(diff_px[whole_walk & ~cut].max()) == 0.0,
                f"{kind}: cull image differs on tiles walked to the end")
        cut_err = 0.0
        if bool((whole_walk & cut).any()):
            cut_err = float(diff_px[whole_walk & cut].max())
            require(cut_err <= SEGMENT_ATOL, f"{kind}: cull image differs "
                                             f"by {cut_err} on cut tiles "
                                             f"walked to the end")
        fig.update(cull_image_max_abs_diff=cull_err,
                   cull_tiles_walked_to_end=int(open_tile.sum()),
                   cull_cut_tiles_walked_to_end=int(
                       (open_tile & cut_tile).sum()),
                   cull_cut_tiles_max_abs_diff=cut_err)

        # ---- K2 with the per-group exit against its plain version
        img = rasterize_tiles(bins, H, W, cfg_s)
        t0 = time.perf_counter()
        img_p, walked, gw = rasterize_tiles_plain(bins, H, W, cfg_s,
                                                  return_walked=True,
                                                  return_group_walked=True)
        torch.cuda.synchronize()
        k2_plain = (time.perf_counter() - t0) * 1e3
        err = float((img - img_p).abs().max())
        require(err <= K2_TOL, f"{kind}: K2 subtile max abs error {err}")
        # the whole-tile exit's image: the plain version's serial walk (K2
        # itself leaves it by the order in which it merges a cut tile's
        # depth segments, within SEGMENT_ATOL)
        whole = rasterize_tiles_plain(bins, H, W, cfg)
        whole_err = float((rasterize_tiles(bins, H, W, cfg) - whole).abs()
                          .max())
        require(whole_err <= SEGMENT_ATOL, f"{kind}: K2 image {whole_err} "
                                           f"off the plain version's")
        pair_count = (bins.tile_end - bins.tile_start).long()
        top = int(torch.argmax(pair_count))
        heavy = pair_count > cfg_s.subtile_heavy_pairs
        if kind == "surface":
            # the silhouette tile takes the grouped walk, and its groups
            # stop apart
            require(bool(heavy[top]) and bool((gw[top] < walked[top]).any()),
                    f"surface: the {int(pair_count[top])}-pair tile did not "
                    f"stop by groups: {gw[top].tolist()}")
        k2_ms, k2_off_ms = (cuda_ms(lambda c=c: rasterize_tiles(bins, H, W, c),
                                    20) for c in (cfg_s, cfg))
        ng = gw.shape[1]
        work = walk_work(bins, H, W, cfg_s, walked, group_n=gw)
        nt = bins.tiles_x * bins.tiles_y
        k2 = kernel_record("rasterize_tiles_subtile",
                           "splat_tpu_torch/csrc/raster.cu",
                           "splat_tpu/render/kernels.py:123", err, k2_ms,
                           k2_plain, 44 * work["walked"] + 8 * nt + 12 * H * W,
                           ALPHA_OPS * work["box3"]
                           + K2_KEPT_OPS * work["kept3"],
                           work["box3"] + K2_KEPT_SFU * work["kept3"])
        subtile_err = float((img - whole).abs().max())
        require(subtile_err <= SUBTILE_ATOL,
                f"{kind}: subtile image {subtile_err} off the whole-tile one")
        fig.update(k2_subtile_ms=k2_ms, k2_ms=k2_off_ms,
                   heavy_tiles=int(heavy.sum()),
                   heaviest_tile_pairs=int(pair_count[top]),
                   heaviest_tile_group_walked=gw[top].tolist(),
                   # pairs x 128-px groups composited, with the whole-tile
                   # exit (each group as far as its tile) and with subtile
                   group_pair_slots_whole=int(walked.sum()) * ng,
                   group_pair_slots_subtile=int(gw.sum()),
                   subtile_vs_whole_image_max_abs_diff=subtile_err,
                   k2_vs_plain_image_max_abs_diff=whole_err)
        recs[kind] = (k1, k2)
        del lay, lay_c, keys, owners, keys_p, owners_p, keys0, bins, bins_c
        del img_p, whole

        def host_ms(c, reps=10):
            # the host's time to enqueue the binning (K1 and the cull rows
            # among it), the card kept ahead by a spinning kernel; before
            # the counted run of the entry points
            torch.cuda.synchronize()
            torch.cuda._sleep(HOLD_CYCLES)
            t0 = time.perf_counter()
            for _ in range(reps):
                binning.build_tile_bins(proj, H, W, c)
            t = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda.synchronize()
            return t

        fig["binning_host_ms"] = {"off": [], "cull_pairs": []}
        for name, c in (("off", cfg), ("cull_pairs", cfg_c)) * 2:
            fig["binning_host_ms"][name].append(host_ms(c))

        # ---- the entry points with each knob, each counted from 0: every
        # render must launch K1 and K2 once, each with its knob's variant,
        # and a capture's warm-up once more for each frame it captured
        def counted(what, fn, cull, subtile, renders=1, captured_frames=1,
                    front=True):
            # front: the renders project through the front end (the slab
            # renders take project_gaussians' records)
            zero_launches(kernels)
            expand.cull_launches = raster.subtile_launches = 0
            caps = graph.counts["captures"]
            out = fn()
            n = renders + (graph.counts["captures"] - caps) * captured_frames
            got = {"K1": expand.launches, "K1_cull": expand.cull_launches,
                   "K2": raster.launches, "K2_subtile": raster.subtile_launches,
                   "K3": kernels[2].launches, "K4": kernels[3].launches,
                   **front_launches(kernels[4])}
            want = {"K1": n, "K1_cull": n * cull, "K2": n,
                    "K2_subtile": n * subtile, "K3": 0, "K4": 0,
                    "front": n * front, "front_count": 0}
            require(got == want, f"{kind} {what}: launches {got}, not {want}")
            launches[what] = got
            return out

        launches: dict = {}
        img_s = counted("render subtile_exit",
                        lambda: stt.render(scene, cam, cfg_s), 0, 1)
        require(torch.equal(img_s, img), f"{kind}: stt.render with "
                                         f"subtile_exit != rasterize_tiles")
        img_c = counted("render cull_pairs",
                        lambda: stt.render(scene, cam, cfg_c), 1, 0)
        img_ct = counted("render_tiled cull_pairs",
                         lambda: stt.render_tiled(scene, cam, cfg_c), 1, 0)
        require(torch.equal(img_c, img_ct), f"{kind}: stt.render with "
                                            f"cull_pairs != render_tiled")
        require(torch.equal(img_c, a1[..., :3]), f"{kind}: the cull image "
                                                 f"differs from phase's")
        del img, img_s, img_ct, a0, a1, rgba
        both = dataclasses.replace(cfg_s, cull_pairs=True)
        img_b = counted("render_tiled both",
                        lambda: stt.render_tiled(scene, cam, both), 1, 1)
        # the slab renders of the sharded paths reach both knobs through
        # the same binning and compositing
        proj_b = project_gaussians(scene, cam, both)
        parts = counted("2 slabs both", lambda: [
            sharding.render_slab_tiled(proj_b, g * (H // 2), H // 2, W, both)
            for g in range(2)], 1, 1, renders=2, front=False)
        require(all(int(o) == 0 for _, o in parts), f"{kind}: slab overflow")
        # the slabs' tile grids differ from the frame's (540 rows), so the
        # whole-tile exits fall elsewhere: each render stops a pixel only
        # below T < alpha_min, and the two differ by less than alpha_min
        slab = torch.cat([p for p, _ in parts])
        slab_err = float((slab - img_b).abs().max())
        slab_psnr = float(stt.psnr(slab, img_b))
        require(slab_err < cfg.alpha_min and slab_psnr >= SLAB_MIN_PSNR,
                f"{kind}: 2-way slab split with both knobs: max abs "
                f"{slab_err}, {slab_psnr:.2f} dB")
        fig.update(slab_split_max_abs_diff=slab_err,
                   slab_split_psnr=slab_psnr)
        for im in (img_c, img_b):
            require(im.shape == (H, W, 3) and bool(torch.isfinite(im).all()),
                    f"{kind}: knob render: bad shape or non-finite values")
        # chained_bench renders one eager frame, then captures its sweep
        # and its audit (each warm-up renders every frame) and replays each
        confs = (("off", cfg, 0, 0), ("subtile_exit", cfg_s, 0, 1),
                 ("cull_pairs", cfg_c, 1, 0))
        sweeps: dict = {name: [] for name, *_ in confs}
        for i, (name, c, cull, sub) in enumerate(confs + confs[::-1]):
            # in turns, there and back
            r = counted(f"sweep {name} {i}", lambda c=c: chained_bench(
                scene, cam, c, SWEEP_FRAMES), cull, sub,
                renders=2 * SWEEP_FRAMES + 1, captured_frames=SWEEP_FRAMES)
            require(r["overflow"] == 0, f"{kind} {name}: overflow")
            sweeps[name].append(r["ms_per_frame"])
        fig["ms_per_frame"] = sweeps
        fig["launches"] = launches
        k1["launches"] = sum(n["K1_cull"] for n in launches.values())
        k2["launches"] = sum(n["K2_subtile"] for n in launches.values())
        figures[kind] = fig
        print(f"[knobs] {kind} {N_BIG} @{W}x{H}: K1 cull exact, kept {kept} "
              f"of {pairs} pairs ({culled} culled), K1 {k1_ms:.4f} ms with "
              f"cull vs {k1_off_ms:.4f} ms without; cull image max abs diff "
              f"{cull_err:.3e} ({int(open_tile.sum())} tiles walked to the "
              f"end, equal there but {cut_err:.3e} on the "
              f"{fig['cull_cut_tiles_walked_to_end']} cut into segments); "
              f"K2 {whole_err:.3e} off its plain version; K2 subtile max "
              f"abs err {err:.3e}, "
              f"{int(heavy.sum())} heavy tiles, "
              f"{fig['group_pair_slots_subtile']} group-pair slots vs "
              f"{fig['group_pair_slots_whole']} "
              f"whole-tile, K2 {k2_ms:.4f} ms subtile vs {k2_off_ms:.4f} ms, "
              f"image {subtile_err:.3e} off the whole-tile one; ms/frame "
              f"{sweeps}; launches {launches}")
        del scene, proj, proj_b
    k1, k2 = recs["random"]
    for rec, srf in zip(recs["random"], recs["surface"]):
        rec.update({f"surface_{key}": srf[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "launches")})
    print(json.dumps({"knobs": figures}).replace("Infinity", '"inf"'))
    return k1, k2, figures


def profile_calls(fn, reps: int, top: int = 6, match: str = "") -> dict:
    """``fn`` called ``reps`` times under ``torch.profiler`` after one
    warm-up call: per call, the device-busy ms, the CUDA kernels launched,
    the ``top`` kernels by device time (names cut to 80 characters) and
    the device ms of the kernels whose name holds ``match``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per: dict[str, float] = {}
    launches = 0
    matched = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            key = evt.key[:80]
            per[key] = per.get(key, 0.0) + evt.self_device_time_total
            launches += evt.count
            if match and match in evt.key:
                matched += evt.self_device_time_total
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_ms": sum(per.values()) / 1e3 / reps,
            "kernels": launches / reps,
            "top_ms": {k: v / 1e3 / reps for k, v in ranked},
            "match_ms": matched / 1e3 / reps}


# the card's names of K1's, K2's and the front end's kernels (K2's
# variants among them)
TRACED_KERNELS = {"K1": "expand_pairs_kernel", "K2": "raster_kernel",
                  "front": "project_front_kernel"}


def traced_launches(run) -> dict:
    """K1's, K2's and the front end's launches that ``torch.profiler`` saw
    the card run during ``run()``: its kernels counted by name, not by the
    wrappers' counters."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    got = dict.fromkeys(TRACED_KERNELS, 0)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            for key, name in TRACED_KERNELS.items():
                if name in evt.key:
                    got[key] += evt.count
    return got


def packed_path(device, kernels, sharded_equal: dict) -> dict:
    """Phase 11: the feature-major scene at the 1M random and surface
    frames @1920x1080.  ``sharded_equal`` is phase 9's comparison of the
    packed shard's sharded renders.  Returns the phase's figures and the
    K1/K2 launches of its ``stt.render`` frames."""
    import torch
    import splat_tpu_torch as stt
    from splat_tpu_torch.render import graph
    from splat_tpu_torch.render.binning import bin_front
    from splat_tpu_torch.render.front import (project_front,
                                              project_front_plain)
    from splat_tpu_torch.render.kernels import rasterize_tiles
    from splat_tpu_torch.scene import PACKED_ROWS, DeviceScene
    from splat_tpu_torch.utils.benchmark import chained_bench

    expand, raster = kernels[:2]
    cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), device=device)
    figures: dict = {"sharded_equal": sharded_equal}
    launches = {"K1": 0, "K2": 0, "front": 0}
    for kind in ("random", "surface"):
        scene, dup = bench_scene(kind, N_BIG, device)
        cfg = stt.RenderConfig(max_dup_factor=dup)
        fig: dict = {}

        # ---- the pack: its time, its memo, its fields
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = scene.pack_device()
        torch.cuda.synchronize()
        fig["pack_first_host_ms"] = (time.perf_counter() - t0) * 1e3
        require(scene.pack_device() is packed, f"{kind}: pack not memoized")
        want = torch.cat([scene.means, scene.quats, scene.scales,
                          scene.opacities[:, None],
                          scene.sh.reshape(N_BIG, 48)], dim=1).T
        require(packed.buffer.shape == (PACKED_ROWS, N_BIG)
                and packed.buffer.is_contiguous()
                and torch.equal(packed.buffer, want),
                f"{kind}: the packed fields differ from the scene's")
        del want
        # an explicit device is a fresh pack each call: five copies
        fig["pack_ms"] = cuda_ms(lambda: scene.pack_device(device), PACK_REPS)
        # each value read once and written once
        fig["pack_bound_ms"] = least_seconds(
            2 * 4 * PACKED_ROWS * N_BIG, 0, 0)[0] * 1e3

        # ---- the frame's front end on both layouts: the pack's rows as
        # they lie, a GaussianScene packed afresh in each call
        layouts = {"unpacked": scene, "packed": packed}
        fig["front_ms"] = {
            name: cuda_ms(lambda sc=sc: project_front(sc, cam, cfg),
                          PROJ_REPS) for name, sc in layouts.items()}
        prof = {name: profile_calls(
            lambda sc=sc: project_front(sc, cam, cfg), PROFILE_REPS)
            for name, sc in layouts.items()}
        fig["front_busy_ms"] = {k: v["busy_ms"] for k, v in prof.items()}
        fig["front_device_ops"] = {k: v["kernels"] for k, v in prof.items()}
        fig["front_top_ms"] = {k: v["top_ms"] for k, v in prof.items()}
        bad = front_mismatch(project_front(scene, cam, cfg),
                             project_front(packed, cam, cfg))
        require(not bad, f"{kind}: front end fields {bad} differ across "
                         f"layouts")

        # ---- the images: both layouts, and the pack's frame binned from
        # the front end's plain version, bit for bit
        img_u, st_u = stt.render_tiled(scene, cam, cfg, return_stats=True)
        img_p, st_p = stt.render_tiled(packed, cam, cfg, return_stats=True)
        require(int(st_u["overflow"]) == 0 and int(st_p["overflow"]) == 0,
                f"{kind}: overflow")
        require(torch.equal(img_u, img_p),
                f"{kind}: render_tiled differs across layouts (max abs "
                f"{float((img_u - img_p).abs().max())})")
        img_f = rasterize_tiles(bin_front(project_front_plain(
            packed, cam, cfg), H, W, cfg), H, W, cfg)
        require(torch.equal(img_f, img_p),
                f"{kind}: render_tiled differs from the frame of the plain "
                f"front end (max abs {float((img_f - img_p).abs().max())})")
        fig["images_equal"] = True
        del img_f

        # ---- stt.render of a GaussianScene: one pack over 3 frames, K1
        # and K2 once a frame, counted from 0
        fresh = dataclasses.replace(scene)           # no memoized pack
        views = [cam.rotate(0.01 * i) for i in range(3)]
        packs = []
        real = DeviceScene.__dict__["from_buffer"]

        def counted(cls, buf, real=real):
            packs.append(tuple(buf.shape))
            return real.__func__(cls, buf)

        DeviceScene.from_buffer = classmethod(counted)
        try:
            zero_launches(kernels)
            caps = graph.counts["captures"]
            imgs = [stt.render(fresh, v, cfg) for v in views]
            torch.cuda.synchronize()
            got = {"K1": expand.launches, "K2": raster.launches,
                   **front_launches(kernels[4]),
                   "captures": graph.counts["captures"] - caps}
        finally:
            DeviceScene.from_buffer = real
        require(len(packs) == 1, f"{kind}: render() packed {len(packs)} "
                                 f"times over 3 frames")
        # one capture of the packed frame, its warm-up launching once, and
        # a replay a frame
        require(got == {"K1": 4, "K2": 4, "front": 4, "front_count": 0,
                        "captures": 1},
                f"{kind}: render() of 3 frames launched {got}")
        for k in launches:
            launches[k] += got[k]
        require(torch.equal(imgs[0], img_p), f"{kind}: render() differs "
                                             f"from render_tiled of the pack")
        for v, img in zip(views[1:], imgs[1:]):
            require(torch.equal(img, stt.render_tiled(fresh.pack_device(), v,
                                                      cfg)),
                    f"{kind}: render() differs from render_tiled")
        fig.update(render_packs=len(packs), render_launches=got)
        del fresh, imgs, img_u, img_p

        # ---- yaw sweeps in turns
        sweeps: dict = {"unpacked": [], "packed": []}
        for name in ("unpacked", "packed", "packed", "unpacked"):
            r = chained_bench(layouts[name], cam, cfg, SWEEP_FRAMES)
            require(r["overflow"] == 0, f"{kind} {name} sweep: overflow")
            sweeps[name].append(r["ms_per_frame"])
        fig["sweep_ms_per_frame"] = sweeps
        figures[kind] = fig
        print(f"[packed] {kind} {N_BIG} @{W}x{H}: pack {fig['pack_ms']:.4f} "
              f"ms (bound {fig['pack_bound_ms']:.4f}; first "
              f"{fig['pack_first_host_ms']:.2f} ms host); front end "
              f"unpacked / packed: {fig['front_ms']['unpacked']:.4f} / "
              f"{fig['front_ms']['packed']:.4f} ms (events, "
              f"{PROJ_REPS} calls), device busy "
              f"{fig['front_busy_ms']['unpacked']:.4f} / "
              f"{fig['front_busy_ms']['packed']:.4f} ms, "
              f"{fig['front_device_ops']['unpacked']:.0f} / "
              f"{fig['front_device_ops']['packed']:.0f} device ops a call; "
              f"images equal, and to the plain front end's frame; render() "
              f"packed once in 3 frames, launches "
              f"{got}; ms/frame unpacked {sweeps['unpacked']}, packed "
              f"{sweeps['packed']}")
        del scene, packed, layouts
    print(json.dumps({"packed": figures}))
    return {"figures": figures, "launches": launches}


def compiled_path(device, kernels) -> dict:
    """Phase 12: the compiled frame (``render/graph.py``, the port's
    ``jax.jit``) at the 1M random and surface frames @1920x1080.  Returns
    the phase's figures and the K1/K2 launches of one replay, as the
    profiler traced them on the card."""
    import statistics
    import tempfile
    import torch
    import splat_tpu_torch as stt
    from splat_tpu_torch.render import graph
    from splat_tpu_torch.render.tiled import render_tiled
    from splat_tpu_torch.utils.benchmark import _sweep_fns, chained_bench

    expand, raster, front = kernels[0], kernels[1], kernels[4]

    def counted_now():
        return {"K1": expand.launches, "K2": raster.launches,
                "front": front.launches}
    cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), device=device)
    figures: dict = {}
    per_replay = {}
    mib = 2.0 ** 20
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    for kind in ("random", "surface"):
        scene, dup = bench_scene(kind, N_BIG, device)
        cfg = stt.RenderConfig(max_dup_factor=dup)
        packed = scene.pack_device()
        fig: dict = {}

        # ---- the CLI orbit, its frames replayed (random: phase 8 runs
        # the surface PLY's)
        if kind == "random":
            with tempfile.TemporaryDirectory(dir=build) as tmp:
                ply = os.path.join(tmp, "random_1m.ply")
                stt.save_ply(ply, scene)
                caps, reps = graph.counts["captures"], graph.counts["replays"]
                zero_launches(kernels)
                out, err = run_cli(["orbit", ply, "--size", f"{W}x{H}",
                                    "--pos", "0,0,4", "--frames",
                                    str(COMPILED_ORBIT_FRAMES),
                                    "--yaw-sweep", "10", "--png-level", "0",
                                    "--dup-factor", str(dup), "--out-dir",
                                    os.path.join(tmp, "orbit"),
                                    "--device", "cuda"])
                got = {"captures": graph.counts["captures"] - caps,
                       "replays": graph.counts["replays"] - reps,
                       **counted_now()}
                # one capture (its warm-up launches once) and a replay a
                # frame
                n = COMPILED_ORBIT_FRAMES
                require(got == {"captures": 1, "replays": n, "K1": n + 1,
                                "K2": n + 1, "front": n + 1}
                        and "WARNING" not in err,
                        f"orbit through the graph: {got} {err}")
                fig["cli_orbit"] = dict(got, ms_per_frame=float(
                    out.split(" ms/frame")[0].split()[-1]))

        # ---- the first call: capture and one replay; the pool it took.
        # Beside it one eager frame (the kernels' library built)
        graph.clear()
        render_tiled(packed, cam, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_tiled(packed, cam, cfg)
        torch.cuda.synchronize()
        fig["eager_frame_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(device)
        f = stt.render_fn("tiled", cfg)
        caps = graph.counts["captures"]
        t0 = time.perf_counter()
        img0 = f(packed, cam)
        torch.cuda.synchronize()
        fig["first_call_ms"] = (time.perf_counter() - t0) * 1e3
        entry = graph.captured(("tiled", cfg, False), packed, cam)
        require(entry is not None and graph.counts["captures"] == caps + 1,
                f"{kind}: render_fn captured no graph")
        fig["capture_ms"] = entry.capture_s * 1e3
        fig["pool_mib"] = entry.pool_bytes / mib
        fig["reserved_mib_after_first_call"] = (
            torch.cuda.memory_reserved(device) - reserved0) / mib

        # ---- replay against eager, bit for bit: the captured pose, a new
        # pose (its replay traced on the card and counted from 0), an
        # in-place edit and its undo
        eq = {"pose_0": torch.equal(img0, render_tiled(packed, cam, cfg))}
        c1 = cam.with_pose(yaw=0.3)
        want1 = render_tiled(packed, c1, cfg)
        zero_launches(kernels)
        reps = graph.counts["replays"]
        out = []
        traced = traced_launches(lambda: out.append(f(packed, c1)))
        img1, = out
        counted = counted_now()
        per_replay[kind] = dict(traced, replays=graph.counts["replays"]
                                - reps, counted=counted)
        require(traced == counted == {"K1": 1, "K2": 1, "front": 1}
                and per_replay[kind]["replays"] == 1,
                f"{kind}: a replay launched {per_replay[kind]}")
        eq["pose_1"] = torch.equal(img1, want1)
        row = packed.buffer[10].clone()               # the opacities
        packed.buffer[10].mul_(0.5)
        img_e = f(packed, c1)
        eq["in_place_edit"] = (torch.equal(img_e, render_tiled(packed, c1,
                                                                cfg))
                               and not torch.equal(img_e, img1))
        packed.buffer[10].copy_(row)
        eq["edit_undone"] = torch.equal(f(packed, c1), img1)
        require(all(eq.values()), f"{kind}: replay vs eager {eq}")
        require(graph.counts["captures"] == caps + 1,
                f"{kind}: a pose or an edit captured again")
        fig["bit_equal"] = eq
        del img0, img1, img_e, want1, row, out

        # ---- render() of a GaussianScene edited in place between frames,
        # and of a scene of inference tensors (re-packed every call): the
        # pack is refilled where it lies, so one capture serves every
        # frame and reserved memory stops growing
        fields = ("means", "quats", "scales", "opacities", "sh")
        for name in ("edited", "inference"):
            with torch.inference_mode(name == "inference"):
                s = stt.GaussianScene(**{k: getattr(scene, k).clone()
                                         for k in fields})
            caps_r = graph.counts["captures"]
            reserved, cached, allocated, same = [], [], [], []
            for _ in range(3):
                with torch.inference_mode(name == "inference"), \
                        torch.no_grad():
                    s.opacities.mul_(0.95)
                img = stt.render(s, cam, cfg, method="tiled")
                same.append(torch.equal(img, render_tiled(
                    s.pack_device(), cam, cfg)))
                torch.cuda.synchronize()
                cached.append(torch.cuda.memory_reserved(device) / mib)
                # the eager reference frame's blocks, freed and cached by
                # the allocator, are not render()'s: released before the
                # reading (they may or may not fit the next reference
                # frame beside render()'s output, and a new segment then
                # comes from the allocator's packing, not from render())
                torch.cuda.empty_cache()
                reserved.append(torch.cuda.memory_reserved(device) / mib)
                allocated.append(torch.cuda.memory_allocated(device) / mib)
            got = {"captures": graph.counts["captures"] - caps_r,
                   "equal": all(same), "reserved_mib": reserved,
                   "allocated_mib": allocated,
                   "reserved_with_cache_mib": cached}
            require(got["captures"] == 1 and got["equal"]
                    and reserved[-1] == reserved[1]
                    and allocated[-1] == allocated[1],
                    f"{kind}: render() of an {name} scene: {got}")
            fig[f"render_{name}_scene"] = got
            del s, img
        del scene

        # ---- the sweep as one captured program against eager dispatch,
        # in turns; the same frames, so the same mean pixel bit for bit
        runs = {"eager": [], "compiled": []}
        for name in ("eager", "compiled", "compiled", "eager"):
            r = chained_bench(packed, cam, cfg, SWEEP_FRAMES,
                              compiled=name == "compiled")
            require(r["overflow"] == 0, f"{kind} {name} sweep: overflow")
            runs[name].append(r)
        means = {r["mean_pixel"] for rs in runs.values() for r in rs}
        require(len(means) == 1, f"{kind}: sweeps differ: {means}")
        fig["ms_per_frame"] = {k: [r["ms_per_frame"] for r in rs]
                               for k, rs in runs.items()}
        fig["sweep_compile_s"] = [r["compile_s"] for r in runs["compiled"]]

        # ---- device busy and idle share of a 10-frame sweep program,
        # eager and captured, profiled; then one replay traced: ten K1 and
        # ten K2 launches on the card, as many as the counters add
        frames = 10
        eager_sweep = _sweep_fns(cfg, frames)[0]
        sweep = graph.capture(eager_sweep, packed, cam)
        for name, prog in (("eager", eager_sweep), ("compiled", sweep)):
            prof = profile_calls(lambda p=prog: p(packed, cam), 1, top=4)
            busy = prof["busy_ms"] / frames
            fig[f"{name}_profile"] = {
                "busy_ms": busy, "device_ops": prof["kernels"] / frames,
                "top_ms": {k: v / frames for k, v in prof["top_ms"].items()},
                "idle_share_of_median_sweep": 1.0 - busy / statistics.median(
                    fig["ms_per_frame"][name])}
        zero_launches(kernels)
        traced = traced_launches(lambda: sweep(packed, cam))
        counted = counted_now()
        require(traced == counted == {"K1": 10, "K2": 10, "front": 10},
                f"{kind}: a 10-frame sweep replay traced {traced}, counted "
                f"{counted}")
        fig["sweep_replay_launches"] = traced
        del sweep
        fig["reserved_mib"] = torch.cuda.memory_reserved(device) / mib
        fig["graphs_cached"] = len(graph._CACHE)

        # ---- the viewer's pose -> bytes through its graph (surface)
        if kind == "surface":
            fig["viewer"] = compiled_viewer(packed, cam, cfg)
        figures[kind] = fig
        ep, cp = fig["eager_profile"], fig["compiled_profile"]
        print(f"[compiled] {kind} {N_BIG} @{W}x{H}: capture "
              f"{fig['capture_ms']:.1f} ms, pool {fig['pool_mib']:.1f} MiB, "
              f"first call {fig['first_call_ms']:.1f} ms (one eager frame "
              f"{fig['eager_frame_ms']:.2f} ms); replay == eager "
              f"bit for bit {eq}; ms/frame eager {fig['ms_per_frame']['eager']}"
              f", compiled {fig['ms_per_frame']['compiled']}; device busy "
              f"{ep['busy_ms']:.4f} / {cp['busy_ms']:.4f} ms, "
              f"idle share {ep['idle_share_of_median_sweep']:.3f} / "
              f"{cp['idle_share_of_median_sweep']:.3f} (eager / compiled); "
              f"launches a replay {per_replay[kind]}; render() of a "
              f"changing scene {fig['render_edited_scene']} / "
              f"{fig['render_inference_scene']}")
        del packed, f, entry
        graph.clear()
    print(json.dumps({"compiled": figures}))
    return {"figures": figures, "per_replay": per_replay}


def compiled_viewer(packed, cam, cfg) -> dict:
    """Phase 12's viewer: ``render_pose`` through its graph equal bit for
    bit to eager, then the median pose -> bytes of raw requests and of
    ``render_pose`` alone, each replaying the graph."""
    import statistics
    import threading
    import urllib.request
    import numpy as np
    import torch
    from splat_tpu_torch.render import graph
    from splat_tpu_torch.render.tiled import render_tiled
    from splat_tpu_torch.viewer.server import make_server

    srv = make_server(packed, cam, cfg, port=0)
    caps, reps = graph.counts["captures"], graph.counts["replays"]
    frame, overflow = srv.render_pose(0.1, 0.0, 1.0, "color", 1.0)
    want = render_tiled(packed, cam.with_pose(yaw=0.1), cfg)
    want = (torch.clamp(want, 0, 1) * 255 + 0.5).to(torch.uint8)
    require(overflow == 0 and np.array_equal(frame, want.cpu().numpy()),
            "viewer render_pose through its graph differs from eager")
    alone = []
    for i in range(VIEWER_REQUESTS):
        t0 = time.perf_counter()
        srv.render_pose(0.02 * i, 0.0, 1.0, "color", 1.0)
        alone.append((time.perf_counter() - t0) * 1e3)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/frame.raw?yaw="
    times = []
    try:
        for i in range(VIEWER_REQUESTS):
            t0 = time.perf_counter()
            with urllib.request.urlopen(url + str(0.02 * i),
                                        timeout=300) as r:
                body, hdr = r.read(), dict(r.headers)
            times.append((time.perf_counter() - t0) * 1e3)
            require(hdr["X-Splat-Overflow"] == "0"
                    and len(body) == cam.w * cam.h * 4, "viewer: raw frame")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    require(not th.is_alive(), "viewer thread did not stop")
    got = {"captures": graph.counts["captures"] - caps,
           "replays": graph.counts["replays"] - reps}
    require(got == {"captures": 1, "replays": 1 + 2 * VIEWER_REQUESTS},
            f"viewer: {got}, not one capture and a replay a frame")
    return dict(got, pose_to_bytes_median_ms=statistics.median(times),
                render_pose_median_ms=statistics.median(alone))


def main(argv) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only-parallel", action="store_true",
                    help="phases 1 and 9 alone (a machine of several cards)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import splat_tpu_torch as stt
    from splat_tpu_torch import _build
    from splat_tpu_torch.ops.projection import project_gaussians
    from splat_tpu_torch.render.diff import (rasterize_train_bwd,
                                             rasterize_train_fwd)
    from splat_tpu_torch.render import graph
    from splat_tpu_torch.render.expand import expand_pair_keys
    from splat_tpu_torch.render.front import project_front
    from splat_tpu_torch.render.kernels import rasterize_tiles

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    # the bounds take splatbench/roofline.py's H100 SXM peaks, whatever
    # this card's SM count
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[card] {sms} SMs; bounds at the H100 SXM's peaks: SFU "
          f"{SFU_OPS_PER_S:.4e} ops/s (16 x 132 SMs x 1980 MHz)")
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {_build.library_path().name}: "
          f"{time.perf_counter() - t0:.2f} s")

    device = torch.device("cuda", 0)
    if args.only_parallel:
        parallel_path()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    kf, kfc = check_front(device)
    cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), device=device)
    recs = {}
    # the surface frame holds the heavy tiles; its plain versions walk
    # 43,502 pairs one by one, so K2's is timed as the one compared call
    for kind, k2_plain_reps in (("random", 2), ("surface", 0)):
        scene, dup = bench_scene(kind, N_BIG, device)
        cfg = stt.RenderConfig(max_dup_factor=dup)
        proj = project_gaussians(scene.pack_device(), cam, cfg)
        print(f"[K1-K4] {kind} {N_BIG} @{W}x{H}:")
        k1, bins = check_expand(proj, H, W, cfg)
        k2 = check_raster(bins, H, W, cfg, k2_plain_reps)
        recs[kind] = (k1, k2, *check_train(bins, H, W, cfg))
        del scene, proj, bins
    k1, k2, k3, k4 = recs["random"]
    for rec, srf in zip(recs["random"], recs["surface"]):
        rec.update({f"surface_{key}": srf[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "alpha_only_bound_ms", "split_tiles", "segments",
            "segments_rewalked", "longest_walk") if key in srf})
    require(k2["surface_split_tiles"] > 0,
            "K2 split no tile at the surface frame")
    bins, cfg, pose = orbit_frame(device)
    print(f"[K2] surface-3m cell @{W}x{H}, seed {ORBIT_SEED}, orbit pose "
          f"{pose} (the heaviest sampled):")
    k2_3m = check_raster(bins, H, W, cfg, 0)
    del bins
    k2.update({f"surface_3m_{key}": k2_3m[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
        "split_tiles", "segments", "segments_rewalked", "longest_walk")})
    require(k2["surface_3m_segments"] > 0 and k2["segments"] == 0,
            f"K2 segments: {k2['surface_3m_segments']} at the surface-3m "
            f"frame, {k2['segments']} at the random one")
    kernels = (expand_pair_keys, rasterize_tiles, rasterize_train_fwd,
               rasterize_train_bwd, project_front)

    def zero_counts():
        zero_launches(kernels)

    def release_graphs():
        # the cached graphs hold their scenes and pools: none outlives its
        # phase
        graph.clear()
        torch.cuda.empty_cache()

    zero_counts()
    main_path(device)
    k1["launches"] = expand_pair_keys.launches
    k2["launches"] = rasterize_tiles.launches
    # a frame launches the front end once, as it launches K1; the fitted
    # scene's render() sizes its capacity by one count-only launch
    fl = front_launches(project_front)
    require(fl == {"front": k1["launches"], "front_count": 1},
            f"front end on the inference path: {fl}, K1 {k1['launches']}")
    kf["launches"] = fl["front"]
    release_graphs()
    zero_counts()
    training_path(device)
    k3["launches"] = rasterize_train_fwd.launches
    k4["launches"] = rasterize_train_bwd.launches
    fl = front_launches(project_front)
    print(f"[train] launches on the training path: K1 "
          f"{expand_pair_keys.launches}, K2 {rasterize_tiles.launches}, "
          f"K3 {k3['launches']}, K4 {k4['launches']}, front end {fl}")
    for k in (k1, k2, k3, k4, kf):
        require(k["launches"] > 0, f"{k['name']} never launched on its "
                                   f"path")
    # count-only, once a view in each fit's capacity audit and in each
    # step's demand pass: the 20k recipe's 4 views, the 1M fits' 2 views
    # (a one-step warm-up and the timed run); the projection of the
    # training steps stays off the kernel.  The 1M fit's two target
    # renders: one capture's warm-up and two replays
    want = {"front": 3, "front_count": 4 * (FIT_STEPS + 1) + 2 * (1 + 1)
            + 2 * (BIG_FIT_STEPS + 1)}
    require(fl == want, f"front end on the training path: {fl}, not {want}")
    kfc["launches"] = fl["front_count"]
    cli_counts = cli_and_viewer(device, kernels)
    release_graphs()
    for k, key in zip((k1, k2, k3, k4), ("K1", "K2", "K3", "K4")):
        k["cli_launches"] = cli_counts["fit" if key in ("K3", "K4")
                                       else "inference"][key]
    kf["cli_launches"] = cli_counts["inference"]["front"]
    kfc["cli_launches"] = cli_counts["fit"]["front_count"]
    par = parallel_path()
    for k, key in zip((k1, k2, k3, k4), ("K1", "K2", "K3", "K4")):
        k["parallel_launches"] = par["launch_totals"][key]
    k1c, k2s, _ = knob_path(device, kernels)
    release_graphs()
    packed = packed_path(device, kernels, par["packed_equal"])
    release_graphs()
    k1["packed_launches"] = packed["launches"]["K1"]
    k2["packed_launches"] = packed["launches"]["K2"]
    kf["packed_launches"] = packed["launches"]["front"]
    comp = compiled_path(device, kernels)
    k1["launches_per_replay"] = comp["per_replay"]["random"]["K1"]
    k2["launches_per_replay"] = comp["per_replay"]["random"]["K2"]
    kf["launches_per_replay"] = comp["per_replay"]["random"]["front"]
    print(json.dumps({"kernels": [k1, k2, k3, k4, k1c, k2s, kf, kfc]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv[1:]:          # a rank of phase 9's world
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main(sys.argv[1:]))
