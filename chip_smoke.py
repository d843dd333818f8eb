"""Smoke run of the PyTorch + CUDA port (``splat_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. print the card's name and power limit, build the CUDA kernels from
     ``splat_tpu_torch/csrc`` and print the build time;
  2. kernel K1 (pair expansion) against its plain PyTorch version at 1M
     gaussians @1920x1080: keys, owners, tile edges, num_pairs and overflow
     must be exactly equal;
  3. kernel K2 (tile compositing) against its plain version on the same
     frame: max abs difference <= K2_TOL;
  3b. kernels K3 and K4 (the training forward and backward) against their
     plain versions on the same frame and on the 1M surface frame, whose
     heavy tiles the kernels split across blocks: C and logT max abs <=
     K3_TOL, the per-tile cut equal, and K4's per-gaussian gradients per
     field within K4_REL_TOL of the field's largest value, cosine >=
     K4_MIN_COS; prints the longest tile walk and both kernels' times;
  4. the inference path with every launch counter at 0: ``render()`` of
     the committed fitted 20k-splat scene (>= 45 dB against the dense
     renderer), then ``render()`` and a timed yaw sweep of 1M random and
     1M surface gaussians @1920x1080 with overflow 0;
  5. K1 and K2 must have launched during phase 4;
  6. the training path with every launch counter at 0: the fitted-20k
     recipe of scripts/make_fitted_scene.py (surface_scene(20_000), 4
     orbit poses at 400x300, perturbed start, ``fit(method="tiled")``,
     L2 + L1 + D-SSIM, lr 5e-3, FIT_STEPS steps; targets from the port's
     ``render_dense``) must more than halve its loss with every loss
     finite; then timed tiled ``fit`` steps on 1M surface gaussians
     @1920x1080 with 2 orbit views and overflow 0;
  7. K3 and K4 must have launched during phase 6.
The second-to-last line is a JSON object describing each kernel, with its
bound (the least time the card could take for its work on these inputs:
bytes over the memory rate, FP32 operations over the FP32 rate, or
special-function operations over the SFU rate, whichever is largest), and
for K3 and K4 the surface frame's figures under ``surface_*`` keys;
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
    print(f"[K1] expand_pair_keys: k_cap={lay.k_cap} pairs={num_pairs} "
          f"overflow={overflow}: exact match; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    return rec, bins


def check_raster(bins, h, w, cfg) -> dict:
    """Phase 3: K2 against its plain version."""
    import torch
    from splat_tpu_torch.render.kernels import (rasterize_tiles,
                                                rasterize_tiles_plain)

    img = rasterize_tiles(bins, h, w, cfg)
    img_p, walked = rasterize_tiles_plain(bins, h, w, cfg,
                                          return_walked=True)
    torch.cuda.synchronize()
    require(img.shape == (h, w, 3) and bool(torch.isfinite(img).all()),
            f"K2 image shape {tuple(img.shape)} or non-finite values")
    err = float((img - img_p).abs().max())
    require(err <= K2_TOL, f"K2 max abs error {err} > {K2_TOL}")
    ms = cuda_ms(lambda: rasterize_tiles(bins, h, w, cfg), 20)
    plain_ms = cuda_ms(lambda: rasterize_tiles_plain(bins, h, w, cfg), 2)
    nt = bins.tiles_x * bins.tiles_y
    evals = int(walked.sum()) * cfg.tile_w * cfg.tile_h
    rec = kernel_record("rasterize_tiles", "splat_tpu_torch/csrc/raster.cu",
                        "splat_tpu/render/kernels.py:123", err, ms, plain_ms,
                        44 * int(bins.num_pairs) + 8 * nt + 12 * h * w,
                        ALPHA_OPS * evals)
    print(f"[K2] rasterize_tiles: max abs err {err:.3e} (tol {K2_TOL}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; {evals} "
          f"pixel-pair evaluations)")
    return rec


def walk_work(bins, h, w, cfg, cut):
    """What K3's and K4's walk (windows [0, cut) of every tile) must
    compute, from the plain version's alpha on the same pairs: the pairs
    walked, and the (pixel, pair) evaluations in the pair's box and the
    kept ones, over every tile pixel (K3) and over the pixels inside the
    image (K4)."""
    import torch
    from splat_tpu_torch.render import diff

    dev = bins.features.device
    s = bins.tile_start.long()
    n = torch.clamp(diff._walk_end(bins, cfg.chunk, cut) - s, min=0)
    tid = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    total = int(n.sum())
    k = s[tid] + torch.arange(total, device=dev) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    pxf, pyf = diff._pixel_grid(bins, cfg, dev)
    inside = diff._tile_pixels(torch.ones((h, w, 1), dtype=torch.bool,
                                          device=dev), bins, cfg)[..., 0]
    use_bbox = math.isfinite(cfg.sigma_cutoff)
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
        ins = inside[tt]
        counts += torch.stack([box.sum(), keep.sum(), (box & ins).sum(),
                               (keep & ins).sum()])
    box3, kept3, box4, kept4 = counts.tolist()
    return {"walked": total, "box3": box3, "kept3": kept3, "box4": box4,
            "kept4": kept4}


def check_train(bins, h, w, cfg):
    """Phase 3b on one frame: K3 and K4 against their plain versions.
    Returns the two kernel records and the frame's walk."""
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
    work = walk_work(bins, h, w, cfg, cut)
    longest = int(torch.clamp(diff._walk_end(bins, cfg.chunk, cut)
                              - bins.tile_start.long(), min=0).max())
    k3 = kernel_record("rasterize_train_fwd",
                       "splat_tpu_torch/csrc/raster_train.cu",
                       "splat_tpu/render/diff.py:211", err3, ms3, plain3,
                       44 * pairs + 12 * nt + 16 * h * w,
                       ALPHA_OPS * work["box3"] + K3_KEPT_OPS * work["kept3"],
                       work["box3"] + K3_KEPT_SFU * work["kept3"])
    # reads the features and owner of each pair, dL/dC, dL/dlogT and logT
    # per pixel; writes 9 floats per gaussian
    k4 = kernel_record("rasterize_train_bwd",
                       "splat_tpu_torch/csrc/raster_train.cu",
                       "splat_tpu/render/diff.py:360", err4, ms4, plain4,
                       52 * pairs + 12 * nt + 20 * h * w + 36 * n,
                       ALPHA_OPS * work["box4"] + K4_KEPT_OPS * work["kept4"],
                       work["box4"] + K4_KEPT_SFU * work["kept4"])
    # the bound of alpha evaluations alone at every walked (pixel, pair)
    alpha_only, _ = bound(0, ALPHA_OPS * work["walked"] * cfg.tile_w
                          * cfg.tile_h)
    for rec, split in ((k3, split3), (k4, split4)):
        rec["alpha_only_bound_ms"] = alpha_only
        rec["split_tiles"] = split
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
    return k3, k4, longest


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
        cfg = stt.RenderConfig(max_dup_factor=dup)
        img = stt.render(scene, cam, cfg)        # raises on overflow
        require(img.shape == (H, W, 3) and bool(torch.isfinite(img).all()),
                f"{kind}: bad shape or non-finite values")
        r = chained_bench(scene, cam, cfg, SWEEP_FRAMES)
        require(r["overflow"] == 0, f"{kind}: overflow {r['overflow']}")
        print(f"[main] {kind} {N_BIG} @{W}x{H} dup {dup}: "
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
    from splat_tpu_torch.render import binning
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
    scene, dup = bench_scene("random", N_BIG, device)
    cfg = stt.RenderConfig(max_dup_factor=dup)
    cam = stt.Camera.create(h=H, w=W, position=(0.0, 0.0, 4.0), device=device)
    proj = project_gaussians(scene, cam, cfg)
    k1, bins = check_expand(proj, H, W, cfg)
    k2 = check_raster(bins, H, W, cfg)
    print(f"[K3/K4] random {N_BIG} @{W}x{H}:")
    k3, k4, _ = check_train(bins, H, W, cfg)
    del scene, proj, bins
    # the heavy tiles: the same gates and timings on the surface frame
    scene, dup = bench_scene("surface", N_BIG, device)
    cfg = stt.RenderConfig(max_dup_factor=dup)
    bins = binning.build_tile_bins(project_gaussians(scene, cam, cfg), H, W,
                                   cfg)
    print(f"[K3/K4] surface {N_BIG} @{W}x{H}:")
    s3, s4, longest = check_train(bins, H, W, cfg)
    for rec, srf in ((k3, s3), (k4, s4)):
        rec.update({f"surface_{key}": srf[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "alpha_only_bound_ms", "split_tiles")})
        rec["surface_longest_walk"] = longest
    del scene, bins
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
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
