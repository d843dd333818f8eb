"""Smoke run of the PyTorch + CUDA port (``splat_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. print the card's name and power limit, build the CUDA kernels from
     ``splat_tpu_torch/csrc`` and print the build time;
  2. kernel K1 (pair expansion) against its plain PyTorch version at 1M
     random gaussians @1920x1080 and at 1M surface gaussians: keys, owners,
     tile edges, num_pairs and overflow must be exactly equal;
  3. kernel K2 (tile compositing) against its plain version on the same
     two frames: max abs difference <= K2_TOL, and at the surface frame,
     whose heavy tiles the kernels split across blocks, at least one tile
     split;
  3b. kernels K3 and K4 (the training forward and backward) against their
     plain versions on the same two frames: C and logT max abs <=
     K3_TOL, the per-tile cut equal, and K4's per-gaussian gradients per
     field within K4_REL_TOL of the field's largest value, cosine >=
     K4_MIN_COS; prints the longest tile walk and both kernels' times;
  4. the inference path with every launch counter at 0: ``render()`` of
     the committed fitted 20k-splat scene (>= 45 dB against the dense
     renderer), then ``render()`` and a timed yaw sweep of 1M random and
     1M surface gaussians @1920x1080 with overflow 0, each scene packed
     by ``pack_device()`` as the repo's bench.py packs it;
  5. K1 and K2 must have launched during phase 4;
  6. the training path with every launch counter at 0: the fitted-20k
     recipe of scripts/make_fitted_scene.py (surface_scene(20_000), 4
     orbit poses at 400x300, perturbed start, ``fit(method="tiled")``,
     L2 + L1 + D-SSIM, lr 5e-3, FIT_STEPS steps; targets from the port's
     ``render_dense``) must more than halve its loss with every loss
     finite; then timed tiled ``fit`` steps on 1M surface gaussians
     @1920x1080 with 2 orbit views and overflow 0;
  7. K3 and K4 must have launched during phase 6;
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
     and K2 must launch on the inference commands, K3 and K4 on ``fit``.
     Prints a JSON line of the phase's times.
  9. the multi-device paths (``splat_tpu_torch.parallel``, ``fit(mesh=)``)
     on a world of one NCCL rank (file store under ``build/``), at the 1M
     surface scene @1920x1080 of phases 4 and 6, every launch counter at 0
     first: ``render_sharded_tiled`` by both routes (a2a forced at g = 1)
     and ``render_batch_sharded_tiled`` over 8 yaw frames, each frame
     within the slab limits of tests/test_sharding.py (>= SLAB_MIN_PSNR,
     under SLAB_MAX_DIFF_SHARE of pixels off by more than 1e-6) of
     ``render_tiled``, overflow 0; the row slabs of a 2-, 4- and 8-way
     split (540, 270 and 135 rows) rendered by ``render_slab_tiled`` in
     this process and stitched, same limits; K1 and K2 must have launched
     on each of these paths, its counts set to 0 just before it.  Then
     ``fit(mesh=make_mesh(1, 1))`` (data parallel over 'd', tensor
     parallel over 'g'), BIG_FIT_STEPS tiled steps on phase 6's 2 views,
     its loss history within FIT_LOSS_RTOL of the nearer of two
     single-device ``fit`` runs (which differ run to run by atomic adds);
     counted from 0 over its own timed run, K3 and K4 must have launched
     once a view and step.  Last,
     ``python -m splat_tpu_torch.parallel.dryrun --world 1`` must exit 0.
     Prints a ``{"parallel": ...}`` JSON line: ms per frame of each route
     and of ``render_tiled`` on the same frames, ms per step of each fit,
     the stitched slabs' PSNR and the launch counts (what the collective
     layer costs at world size 1; no multi-GPU time).
  10. the two knobs at the 1M random and surface frames @1920x1080:
     ``cull_pairs``: K1's cull equal to its plain version (keys and owners),
     pairs culled, num_pairs the pairs kept, overflow 0, the image within
     alpha_min of the no-cull one and equal on tiles walked to their end;
     ``subtile_exit``: K2's grouped walk within K2_TOL of its plain version,
     its image within SUBTILE_ATOL of the whole-tile one, and at the
     surface frame the heaviest tile on the grouped walk with groups that
     stop apart.  Then, each counted from 0 and held to exactly one K1 and
     one K2 launch a render with its knob's variant: ``stt.render`` with
     each knob (equal bit for bit to ``rasterize_tiles`` on the same bins
     and to ``render_tiled``), ``render_tiled`` with both, a 2-way slab
     split with both (within alpha_min of it), and yaw sweeps of each
     setting in turns.  Prints a ``{"knobs": ...}`` JSON line.
  11. the feature-major scene (``pack_device()``, one (59, N) buffer) at
     the 1M random and surface frames @1920x1080: the pack's time and its
     fields equal to the scene's; ``project_gaussians`` on both layouts,
     its time with CUDA events (PROJ_REPS calls behind the spinning
     kernel), its device-busy time and CUDA kernels a call from
     ``torch.profiler``; ``render_tiled`` on both layouts equal bit for
     bit, overflow 0; ``stt.render`` of a ``GaussianScene`` packing once
     over 3 frames and equal to ``render_tiled`` of the pack, with K1 and
     K2 launched once a frame, counted from 0; yaw sweeps of both layouts
     in turns (unpacked, packed, packed, unpacked).  Phase 9 adds
     ``render_sharded_tiled`` at world size 1 of the packed scene's
     shard, by both routes, equal bit for bit to the unpacked shard's.
     Prints a ``{"packed": ...}`` JSON line.
The second-to-last line is a JSON object describing each kernel, with its
bound (the least time the card could take for its work on these inputs:
bytes over the memory rate, FP32 operations over the FP32 rate, or
special-function operations over the SFU rate, whichever is largest), and
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
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
FITTED_PLY = os.path.join(ROOT, "tests", "data", "fitted_20k.ply")
N_BIG = 1_000_000
H, W = 1080, 1920
# K2 tolerance: kernel and plain version do the same f32 operations in the
# same order; only library rounding (expf) may differ.
K2_TOL = 1e-4
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
VIEWER_REQUESTS = 10       # phase 8: timed raw requests at 1080p
# phase 9: a slab-split render against one render_tiled, as
# tests/test_sharding.py holds splat_tpu's (the slabs' tile grids differ,
# so K2's whole-tile exit falls elsewhere)
SLAB_MIN_PSNR = 55.0
SLAB_MAX_DIFF_SHARE = 0.002
PARALLEL_FRAMES = 8
# phase 9: fit(mesh=) at world size 1 against the nearer of two single-
# device fits (K4's atomics add in a run-dependent order; on the H100 two
# single-device runs of the same 3 steps differed by 9.66e-6 relative,
# and the mesh's history equalled one of them exactly: PERF.md, section 5)
FIT_LOSS_RTOL = 1e-5
# phase 10: the subtile_exit image against the whole-tile one, at the
# tolerance tests/test_tiled.py holds splat_tpu's to (a group stops only
# once its pixels have T < alpha_min / 4096, so it leaves out less)
SUBTILE_ATOL = 1e-6
# phase 11: projections timed with CUDA events, profiled, and packs timed
PROJ_REPS = 20
PROFILE_REPS = 5
PACK_REPS = 5
# The card's peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W):
# HBM bytes per second, and FP32 operations per second outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Special-function unit results per SM per clock at compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput), at the
# SM clock nvidia-smi reports as the card's maximum.
SFU_OPS_PER_SM_CLOCK = 16
# Operations to evaluate one pair's alpha at one pixel (K2/K3/K4): dx, dy,
# three products, the quadratic form (3 mul + 2 add), the opacity product,
# the clamp, the alpha_min test, the box test; its expf is one SFU op.
ALPHA_OPS = 14
# Per kept (pixel, pair): K3's clamp, weight, 3 colour mul + add, T update
# (sub, mul) and logT add, with log1pf as one SFU op; K4's clamp, lt_i,
# min, gc (3 mul + 2 add), weight, dalpha (2 mul, 2 sub), dpower, 6
# geometry and 3 colour mul + add, D update (mul, add), with log1pf, expf
# and the division as three SFU ops.
K3_KEPT_OPS, K3_KEPT_SFU = 10, 1
K4_KEPT_OPS, K4_KEPT_SFU = 33, 3
# K2 per kept (pixel, pair): the weight, 3 colour mul + add, the T update
# (sub, mul); no special-function operation
K2_KEPT_OPS, K2_KEPT_SFU = 9, 0
# A short kernel is timed behind this many cycles of a spinning kernel, so
# that the host has queued every launch before the first one starts
# (~5 ms; K1 takes less on the card than its wrapper takes on the host).
HOLD_CYCLES = 10_000_000
SFU_OPS_PER_S = None      # set by main() from the card


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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


def bound(nbytes: float, ops: float, sfu: float = 0.0) -> tuple[float, str]:
    """The least milliseconds the card could take: the largest of the
    bytes over the memory rate, the FP32 operations over the FP32 rate and
    the special-function operations over the SFU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_record(name, source, replaces, err, ms, plain_ms, nbytes, ops,
                  sfu=0.0):
    bound_ms, bound_by = bound(nbytes, ops, sfu)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def bench_scene(kind: str, n: int, device):
    """The scenes and capacities of the repo's bench.py headline cells."""
    import splat_tpu_torch as stt
    if kind == "surface":
        return stt.surface_scene(n, seed=0, device=device), 1.45
    return stt.random_scene(n, seed=0, extent=3.0, scale_range=(0.004, 0.03),
                            device=device), 2.05


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
    t0 = time.perf_counter()
    img_p, walked = rasterize_tiles_plain(bins, h, w, cfg,
                                          return_walked=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    require(img.shape == (h, w, 3) and bool(torch.isfinite(img).all()),
            f"K2 image shape {tuple(img.shape)} or non-finite values")
    err = float((img - img_p).abs().max())
    require(err <= K2_TOL, f"K2 max abs error {err} > {K2_TOL}")
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
    rec["alpha_only_bound_ms"], _ = bound(
        0, ALPHA_OPS * work["walked"] * cfg.tile_w * cfg.tile_h)
    rec["split_tiles"] = split
    rec["longest_walk"] = int(walked.max())
    print(f"[K2] rasterize_tiles: max abs err {err:.3e} (tol {K2_TOL}); "
          f"{work['walked']} of {int(bins.num_pairs)} pairs walked, longest "
          f"tile walk {rec['longest_walk']}, {split} tiles split; kernel "
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
    alpha_only, _ = bound(0, ALPHA_OPS * work["walked"] * cfg.tile_w
                          * cfg.tile_h)
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
    from splat_tpu_torch.render.tiled import render_tiled
    from splat_tpu_torch.utils.image import read_png, write_png
    from splat_tpu_torch.viewer.server import make_server

    expand, raster, fwd, bwd = kernels
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
        for fn in kernels:
            fn.launches = 0
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
        counts = [fn.launches for fn in kernels]
        want = stt.render(scene, cam, cfg, as_uint8=True).cpu().numpy()
        for fn, n in zip(kernels, counts):   # the reference is not the path
            fn.launches = n
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
                     "K3": fwd.launches, "K4": bwd.launches}
        # the same poses without the server: what a request spends in the
        # render, the overflow read and the copy to the host (not counted)
        frame_ms = []
        for i in range(VIEWER_REQUESTS):
            c = cam.with_pose(yaw=0.02 * i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                img, st = render_tiled(scene.pack_device(), c, cfg,
                                       return_stats=True)
                int(st["overflow"])
                (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(
                    torch.uint8).cpu().numpy()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        for fn, key in zip(kernels, ("K1", "K2", "K3", "K4")):
            fn.launches = inference[key]
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
        for fn in kernels:
            fn.launches = 0
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
                    "K3": fwd.launches, "K4": bwd.launches}
        print(f"[cli fit] {len(se3)} SE(3) views @400x300, {FIT_STEPS} "
              f"tiled steps from a perturbed fitted_20k: loss {first:.5f} "
              f"-> {last:.5f}; {fit_s * 1e3 / FIT_STEPS:.2f} ms/step "
              f"(whole command / steps: load, capacity audit, final PSNR "
              f"renders and PLY write included)")
    require(inference["K1"] > 0 and inference["K2"] > 0,
            f"K1/K2 did not launch on render/orbit/bench/serve: {inference}")
    require(training["K3"] > 0 and training["K4"] > 0,
            f"K3/K4 did not launch on fit: {training}")
    print(f"[cli] launches on render/orbit/bench/serve: {inference}; on "
          f"fit: {training}")
    print(json.dumps({"cli": {
        "native_load_ms": t_native * 1e3, "numpy_load_ms": t_numpy * 1e3,
        "cache_load_ms": t_cache * 1e3, "orbit_ms_per_frame": orbit_ms,
        "bench_ms_per_frame": bench_ms, "viewer_pose_to_bytes_ms": viewer_ms,
        "viewer_render_and_copy_ms": statistics.median(frame_ms),
        "fit_ms_per_step": fit_s * 1e3 / FIT_STEPS}}))
    return {"inference": inference, "fit": training}


def slab_check(got, want, what: str) -> float:
    """The slab limits of phase 9; returns the PSNR."""
    import torch
    import splat_tpu_torch as stt
    p = float(stt.psnr(got, want))
    share = float(((got - want).abs() > 1e-6).float().mean())
    require(p >= SLAB_MIN_PSNR and share < SLAB_MAX_DIFF_SHARE,
            f"{what}: {p:.2f} dB, {share:.5f} of pixels off > 1e-6")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    return p


def parallel_path(device, kernels) -> dict:
    """Phase 9: the sharded renders, the slab split and fit(mesh=) on a
    world of one NCCL rank.  Returns the launch counts."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    import splat_tpu_torch as stt
    from splat_tpu_torch.ops.projection import project_gaussians
    from splat_tpu_torch.parallel import sharding

    expand, raster, fwd, bwd = kernels

    def zero_counts():
        for fn in kernels:
            fn.launches = 0

    def frames_ms(render, views) -> float:
        render(views[0])                              # warm-up
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for v in views:
            render(v)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / len(views)

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    res: dict = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], "world_size": 1}
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = sharding.make_mesh(1, 1, device="cuda")
            scene, dup = bench_scene("surface", N_BIG, device)
            local = sharding.shard_scene(scene, mesh)
            cfg = stt.RenderConfig(max_dup_factor=dup)
            cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0),
                                    device=device)
            views = stt.stack_cameras([cam.rotate(0.01 * i)
                                       for i in range(PARALLEL_FRAMES)])
            refs = [stt.render_tiled(scene, v, cfg) for v in views]
            # each sharded path is driven with the counts set to 0 just
            # before it and read just after
            launches: dict = {}

            def counted(path: str, run):
                zero_counts()
                out = run()
                launches[path] = {"K1": expand.launches,
                                  "K2": raster.launches}
                require(expand.launches > 0 and raster.launches > 0,
                        f"K1/K2 did not launch on {path}: {launches[path]}")
                return out

            psnr = {}
            plocal = sharding.shard_scene(scene.pack_device(), mesh)
            res["packed_equal"] = {}
            for route in ("gather", "a2a"):
                img, ov = counted(
                    f"render_sharded_tiled_{route}",
                    lambda route=route: sharding.render_sharded_tiled(
                        local, cam, mesh, cfg, route=route))
                require(int(ov) == 0, f"sharded {route}: overflow {int(ov)}")
                psnr[route] = slab_check(img, refs[0], f"sharded {route}")
                # phase 11's sharded case: the packed scene's shard
                pimg, pov = counted(
                    f"render_sharded_tiled_{route}_packed",
                    lambda route=route: sharding.render_sharded_tiled(
                        plocal, cam, mesh, cfg, route=route))
                require(int(pov) == 0 and torch.equal(pimg, img),
                        f"sharded {route}: the packed shard's image differs "
                        f"from the unpacked shard's")
                res["packed_equal"][route] = True
            imgs, ov = counted(
                "render_batch_sharded_tiled",
                lambda: sharding.render_batch_sharded_tiled(local, views,
                                                            mesh, cfg))
            require(int(ov) == 0, f"sharded batch: overflow {int(ov)}")
            psnr["batch_min"] = min(
                slab_check(imgs[i], refs[i], f"sharded batch frame {i}")
                for i in range(PARALLEL_FRAMES))
            proj = project_gaussians(scene, cam, cfg)
            slab_psnr = {}
            for n_g in (2, 4, 8):
                h_local = H // n_g
                parts = counted(
                    f"render_slab_tiled_{n_g}way",
                    lambda n_g=n_g, h_local=h_local: [
                        sharding.render_slab_tiled(proj, g * h_local,
                                                   h_local, W, cfg)
                        for g in range(n_g)])
                require(all(int(o) == 0 for _, o in parts),
                        f"slab split {n_g}: overflow")
                slab_psnr[str(n_g)] = slab_check(
                    torch.cat([p for p, _ in parts]), refs[0],
                    f"{n_g}-way slab split ({h_local} rows)")
            res["psnr_vs_render_tiled"] = psnr
            res["slab_split_psnr"] = slab_psnr
            res["ms_per_frame"] = {
                "render_tiled": frames_ms(
                    lambda v: stt.render_tiled(scene, v, cfg), views),
                **{f"sharded_{r}": frames_ms(
                    lambda v, r=r: sharding.render_sharded_tiled(
                        local, v, mesh, cfg, route=r), views)
                   for r in ("gather", "a2a")}}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharding.render_batch_sharded_tiled(local, views, mesh, cfg)
            torch.cuda.synchronize()
            res["ms_per_frame"]["sharded_batch_host_clock"] = (
                (time.perf_counter() - t0) * 1e3 / PARALLEL_FRAMES)
            del scene, local, plocal, proj, refs, imgs

            # training: phase 6's 1M surface views, single-device, then on
            # the mesh (data parallel over 'd', tensor parallel over 'g':
            # each axis of one rank)
            truth = stt.surface_scene(N_BIG, seed=0, device=device)
            cams = stt.orbit_trajectory(cam, 2, yaw_sweep=0.05)
            fcfg = stt.RenderConfig(max_dup_factor=1.45)
            targets = torch.stack([stt.render(truth, c, fcfg) for c in cams])
            start = dataclasses.replace(truth, sh=truth.sh * 0.8)
            del truth
            fits, fit_ms = {}, {}
            for name, kw in (("single", {}), ("mesh_1x1", {"mesh": mesh})):
                def run(steps, kw=kw):
                    return stt.fit(start, cams, targets, steps=steps,
                                   lr=5e-3, config=fcfg, method="tiled",
                                   l1_weight=0.2, dssim_weight=0.2, **kw)
                # warm-up; the single-device fit's is a whole second run
                warm = run(BIG_FIT_STEPS if name == "single" else 1)
                torch.cuda.synchronize()
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                zero_counts()
                t0.record()
                out = run(BIG_FIT_STEPS)
                t1.record()
                torch.cuda.synchronize()
                if name != "single":
                    launches[f"fit_{name}"] = {"K3": fwd.launches,
                                               "K4": bwd.launches}
                    want = BIG_FIT_STEPS * len(cams)
                    require(fwd.launches == bwd.launches == want,
                            f"fit {name}: K3/K4 launched {fwd.launches}/"
                            f"{bwd.launches} times, not once a view and "
                            f"step ({want})")
                fit_ms[name] = t0.elapsed_time(t1) / BIG_FIT_STEPS
                fits[name] = out.losses.cpu().numpy().astype(np.float64)
                require(bool(np.isfinite(fits[name]).all()),
                        f"fit {name}: non-finite loss")
                if name == "single":
                    singles = [warm.losses.cpu().numpy().astype(np.float64),
                               fits[name]]

            def rel_diff(a, b) -> float:
                return float(np.max(np.abs(a - b) / np.abs(b)))

            # the single-device fit varies run to run on the card (atomic
            # adds in K4 and in autograd's index backward): the mesh's
            # history is held against the nearer of two single-device runs
            res["fit_single_run_to_run_rel_diff"] = rel_diff(*singles)
            rel = min(rel_diff(fits["mesh_1x1"], s) for s in singles)
            require(rel <= FIT_LOSS_RTOL, f"fit on the mesh: losses "
                    f"{fits['mesh_1x1']} vs single {singles} "
                    f"({rel:.2e} relative)")
            res["fit_mesh_1x1_max_rel_loss_diff"] = rel
            res["launches"] = launches
            res["fit_ms_per_step"] = fit_ms
            res["fit_losses"] = {k: [float(x) for x in v]
                                 for k, v in fits.items()}
            del start, targets
        finally:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    dry = subprocess.run(
        [sys.executable, "-m", "splat_tpu_torch.parallel.dryrun", "--world",
         "1", "--timeout", "300"], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    res["dryrun_s"] = time.perf_counter() - t0
    print(dry.stdout.strip())
    require(dry.returncode == 0, f"dryrun --world 1 exited "
                                 f"{dry.returncode}: {dry.stderr[-2000:]}")
    for key, ms in res["ms_per_frame"].items():
        print(f"[parallel] {key}: {ms:.3f} ms/frame")
    for key, ms in res["fit_ms_per_step"].items():
        print(f"[parallel] fit {key}: {ms:.3f} ms/step")
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
    from splat_tpu_torch.render import binning
    from splat_tpu_torch.render.expand import expand_pair_keys_plain
    from splat_tpu_torch.render.kernels import (rasterize_tiles,
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
        # whole-tile exit fell on other batch boundaries
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
        require(float(diff_px[whole_walk].max()) == 0.0,
                f"{kind}: cull image differs on tiles walked to the end")
        fig.update(cull_image_max_abs_diff=cull_err,
                   cull_tiles_walked_to_end=int(open_tile.sum()))

        # ---- K2 with the per-group exit against its plain version
        bins = binning.build_tile_bins(proj, H, W, cfg)
        img = rasterize_tiles(bins, H, W, cfg_s)
        t0 = time.perf_counter()
        img_p, walked, gw = rasterize_tiles_plain(bins, H, W, cfg_s,
                                                  return_walked=True,
                                                  return_group_walked=True)
        torch.cuda.synchronize()
        k2_plain = (time.perf_counter() - t0) * 1e3
        err = float((img - img_p).abs().max())
        require(err <= K2_TOL, f"{kind}: K2 subtile max abs error {err}")
        whole = rasterize_tiles(bins, H, W, cfg)
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
                   subtile_vs_whole_image_max_abs_diff=subtile_err)
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
        # render must launch K1 and K2 once, each with its knob's variant
        def counted(what, fn, cull, subtile, renders=1):
            for f in kernels:
                f.launches = 0
            expand.cull_launches = raster.subtile_launches = 0
            out = fn()
            got = {"K1": expand.launches, "K1_cull": expand.cull_launches,
                   "K2": raster.launches, "K2_subtile": raster.subtile_launches,
                   "K3": kernels[2].launches, "K4": kernels[3].launches}
            want = {"K1": renders, "K1_cull": renders * cull, "K2": renders,
                    "K2_subtile": renders * subtile, "K3": 0, "K4": 0}
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
            for g in range(2)], 1, 1, renders=2)
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
        # chained_bench renders 2 * frames + 1 times
        confs = (("off", cfg, 0, 0), ("subtile_exit", cfg_s, 0, 1),
                 ("cull_pairs", cfg_c, 1, 0))
        sweeps: dict = {name: [] for name, *_ in confs}
        for i, (name, c, cull, sub) in enumerate(confs + confs[::-1]):
            # in turns, there and back
            r = counted(f"sweep {name} {i}", lambda c=c: chained_bench(
                scene, cam, c, SWEEP_FRAMES), cull, sub,
                renders=2 * SWEEP_FRAMES + 1)
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
              f"end, equal there); K2 subtile max abs err {err:.3e}, "
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


def profile_calls(fn, reps: int, top: int = 6) -> dict:
    """``fn`` called ``reps`` times under ``torch.profiler`` after one
    warm-up call: per call, the device-busy ms, the CUDA kernels launched
    and the ``top`` kernels by device time (names cut to 80 characters)."""
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
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            key = evt.key[:80]
            per[key] = per.get(key, 0.0) + evt.self_device_time_total
            launches += evt.count
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_ms": sum(per.values()) / 1e3 / reps,
            "kernels": launches / reps,
            "top_ms": {k: v / 1e3 / reps for k, v in ranked}}


def packed_path(device, kernels, sharded_equal: dict) -> dict:
    """Phase 11: the feature-major scene at the 1M random and surface
    frames @1920x1080.  ``sharded_equal`` is phase 9's comparison of the
    packed shard's sharded renders.  Returns the phase's figures and the
    K1/K2 launches of its ``stt.render`` frames."""
    import torch
    import splat_tpu_torch as stt
    from splat_tpu_torch.ops.projection import project_gaussians
    from splat_tpu_torch.scene import PACKED_ROWS, DeviceScene
    from splat_tpu_torch.utils.benchmark import chained_bench

    expand, raster = kernels[:2]
    cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), device=device)
    figures: dict = {"sharded_world_1_equal": sharded_equal}
    launches = {"K1": 0, "K2": 0}
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
        fig["pack_bound_ms"], _ = bound(2 * 4 * PACKED_ROWS * N_BIG, 0)

        # ---- the projection on both layouts
        layouts = {"unpacked": scene, "packed": packed}
        fig["projection_ms"] = {
            name: cuda_ms(lambda sc=sc: project_gaussians(sc, cam, cfg),
                          PROJ_REPS) for name, sc in layouts.items()}
        prof = {name: profile_calls(
            lambda sc=sc: project_gaussians(sc, cam, cfg), PROFILE_REPS)
            for name, sc in layouts.items()}
        fig["projection_busy_ms"] = {k: v["busy_ms"] for k, v in prof.items()}
        fig["projection_kernels"] = {k: v["kernels"] for k, v in prof.items()}
        fig["projection_top_ms"] = {k: v["top_ms"] for k, v in prof.items()}
        a = project_gaussians(scene, cam, cfg)
        b = project_gaussians(packed, cam, cfg)
        require(all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                    for f in dataclasses.fields(a)),
                f"{kind}: projected fields differ across layouts")
        del a, b

        # ---- the images on both layouts, bit for bit
        img_u, st_u = stt.render_tiled(scene, cam, cfg, return_stats=True)
        img_p, st_p = stt.render_tiled(packed, cam, cfg, return_stats=True)
        require(int(st_u["overflow"]) == 0 and int(st_p["overflow"]) == 0,
                f"{kind}: overflow")
        require(torch.equal(img_u, img_p),
                f"{kind}: render_tiled differs across layouts (max abs "
                f"{float((img_u - img_p).abs().max())})")
        fig["images_equal"] = True

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
            for fn in kernels:
                fn.launches = 0
            imgs = [stt.render(fresh, v, cfg) for v in views]
            torch.cuda.synchronize()
            got = {"K1": expand.launches, "K2": raster.launches}
        finally:
            DeviceScene.from_buffer = real
        require(len(packs) == 1, f"{kind}: render() packed {len(packs)} "
                                 f"times over 3 frames")
        require(got == {"K1": 3, "K2": 3},
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
              f"{fig['pack_first_host_ms']:.2f} ms host); projection "
              f"unpacked / packed: {fig['projection_ms']['unpacked']:.4f} / "
              f"{fig['projection_ms']['packed']:.4f} ms (events, "
              f"{PROJ_REPS} calls), device busy "
              f"{fig['projection_busy_ms']['unpacked']:.4f} / "
              f"{fig['projection_busy_ms']['packed']:.4f} ms, "
              f"{fig['projection_kernels']['unpacked']:.0f} / "
              f"{fig['projection_kernels']['packed']:.0f} kernels a call; "
              f"images equal; render() packed once in 3 frames, launches "
              f"{got}; ms/frame unpacked {sweeps['unpacked']}, packed "
              f"{sweeps['packed']}")
        del scene, packed, layouts
    print(json.dumps({"packed": figures}))
    return {"figures": figures, "launches": launches}


def main() -> int:
    import torch
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
    from splat_tpu_torch.render.expand import expand_pair_keys
    from splat_tpu_torch.render.kernels import rasterize_tiles

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    global SFU_OPS_PER_S
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SFU_OPS_PER_S = SFU_OPS_PER_SM_CLOCK * sms * max_mhz * 1e6
    print(f"[card] {sms} SMs, max SM clock {max_mhz:.0f} MHz: SFU "
          f"{SFU_OPS_PER_S:.4e} ops/s")
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {_build.library_path().name}: "
          f"{time.perf_counter() - t0:.2f} s")

    device = torch.device("cuda", 0)
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
            "alpha_only_bound_ms", "split_tiles", "longest_walk")
            if key in srf})
    require(k2["surface_split_tiles"] > 0,
            "K2 split no tile at the surface frame")
    kernels = (expand_pair_keys, rasterize_tiles, rasterize_train_fwd,
               rasterize_train_bwd)

    def zero_counts():
        for fn in kernels:
            fn.launches = 0

    zero_counts()
    main_path(device)
    k1["launches"] = expand_pair_keys.launches
    k2["launches"] = rasterize_tiles.launches
    zero_counts()
    training_path(device)
    k3["launches"] = rasterize_train_fwd.launches
    k4["launches"] = rasterize_train_bwd.launches
    print(f"[train] launches on the training path: K1 "
          f"{expand_pair_keys.launches}, K2 {rasterize_tiles.launches}, "
          f"K3 {k3['launches']}, K4 {k4['launches']}")
    for k in (k1, k2, k3, k4):
        require(k["launches"] > 0, f"{k['name']} never launched on its "
                                   f"path")
    cli_counts = cli_and_viewer(device, kernels)
    for k, key in zip((k1, k2, k3, k4), ("K1", "K2", "K3", "K4")):
        k["cli_launches"] = cli_counts["fit" if key in ("K3", "K4")
                                       else "inference"][key]
    par = parallel_path(device, kernels)
    for k, key in zip((k1, k2, k3, k4), ("K1", "K2", "K3", "K4")):
        k["parallel_launches"] = sum(n.get(key, 0)
                                     for n in par["launches"].values())
    k1c, k2s, _ = knob_path(device, kernels)
    packed = packed_path(device, kernels, par["packed_equal"])
    k1["packed_launches"] = packed["launches"]["K1"]
    k2["packed_launches"] = packed["launches"]["K2"]
    print(json.dumps({"kernels": [k1, k2, k3, k4, k1c, k2s]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
