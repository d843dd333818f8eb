"""Where the inference kernels (K2 compositing, K1 pair expansion) spend
their time, on one card.

    python -m splat_tpu_torch.utils.raster_probe probe --old-raster OLD.cu
    python -m splat_tpu_torch.utils.raster_probe stamp
    python -m splat_tpu_torch.utils.raster_probe tune
    python -m splat_tpu_torch.utils.raster_probe compare \\
        --old-raster OLD_raster.cu --old-expand OLD_expand.cu

``OLD*.cu`` are earlier ``csrc/raster.cu`` / ``csrc/expand.cu`` with one
block per tile and one search per slot (for example taken from git history
into the gitignored ``build/``).  Each is compiled on its own into
``build/probe/`` and called through its C entry point, which keeps the
earlier argument list.  The helpers are those of ``train_probe``.

* ``probe`` instruments the earlier K2: each block records its start, its
  end (``%globaltimer``) and its SM.  At the random and the surface 1M
  @1080p frames it prints the kernel span, the heaviest tile's block time,
  how many pairs the exit lets each tile walk (the plain version's
  ``return_walked``) against the pairs it holds, the kernel time with every
  tile but the heaviest emptied, and per warp strip how many walked pairs
  pass the bbox test.
* ``stamp`` instruments the current K2 (one stamp per block, with its tile
  and pixel group) and runs it through ``rasterize_tiles``: the span, when
  the split tiles' blocks start and end, and how busy the SMs are.
* ``tune`` times the current K2 against variants of its source (and whole
  other sources with the current argument list, ``--sources NAME=PATH``;
  ``--variants NAME ...`` builds only those; ``--subtile`` times the
  kernel with ``subtile_exit`` on)
  and against other split thresholds, on both frames, in turns; and the
  device and host time of the work list built by PyTorch calls
  (``render/plan.py::_tile_plan``, the plan kernel's plain version), which
  the plan kernel inside K2's launch replaces.
* ``compare`` times the earlier K2 and K1 against the current ones on both
  frames, in turns (old, new, new, old), with CUDA events, and the 30-frame
  sweep of ``chained_bench`` with the earlier and the current kernels.

Registers and spills (``nvcc -Xptxas -v``) are printed first.  One JSON
object per frame goes to stdout.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import math
import pathlib
import re
import subprocess
import time

import torch

from splat_tpu_torch import _build
from splat_tpu_torch.utils import train_probe as tp

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# the C entry points of the earlier sources (their argument lists)
_OLD_RASTER = [_P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F,
               _F, _I, _I, _I, _P]
_OLD_EXPAND = [_P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _P, _P, _P]
RASTER_ENTRIES = ("splat_rasterize",)

_PROBE_TAIL = tp._PROBE_HELPERS + r"""
__global__ void __launch_bounds__(256) probe_raster_kernel(
    const int32_t* ts, const int32_t* te, const float* feats, int64_t kp,
    float* out, int H, int W, int tile_w, int tile_h, int tiles_x, int chunk,
    float alpha_clamp, float alpha_min, float bg0, float bg1, float bg2,
    int nchan, int use_bbox, long long* times) {
  const long long t0 = probe_now();
  raster_body<4>(ts, te, feats, kp, out, H, W, tile_w, tile_h, tiles_x,
                 chunk, alpha_clamp, alpha_min, bg0, bg1, bg2, nchan,
                 use_bbox);
  probe_stamp(times, t0);
}
extern "C" int probe_raster(const void* ts, const void* te,
    const void* feats, int64_t kp, void* out, int H, int W, int tile_w,
    int tile_h, int tiles_x, int num_tiles, int chunk, float alpha_clamp,
    float alpha_min, float bg0, float bg1, float bg2, int nchan,
    int use_bbox, void* times) {
  probe_raster_kernel<<<num_tiles, 256, (size_t)NF * chunk * sizeof(float)>>>(
      (const int32_t*)ts, (const int32_t*)te, (const float*)feats, kp,
      (float*)out, H, W, tile_w, tile_h, tiles_x, chunk, alpha_clamp,
      alpha_min, bg0, bg1, bg2, nchan, use_bbox, (long long*)times);
  return (int)cudaGetLastError();
}
"""


def _compile(name: str, text: str) -> pathlib.Path:
    """``text`` as ``build/probe/<name>.cu`` compiled into a library of its
    own; prints its registers and spills."""
    tp.PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src = tp.PROBE_DIR / f"{name}.cu"
    src.write_text(text)
    log = tp._nvcc(src, src.with_suffix(".so"), verbose=True)
    print(f"[regs] {src.name}: " + "; ".join(tp._registers(log)), flush=True)
    return src.with_suffix(".so")


def load_old_raster(old: pathlib.Path, probe: bool) -> ctypes.CDLL:
    """The earlier K2 source as its own library (instrumented with probe)."""
    text = old.read_text()
    if probe:
        text, n = re.subn(
            r"__global__ void __launch_bounds__\(256\) raster_kernel\(",
            "__device__ __forceinline__ void raster_body(", text)
        if n != 1:
            raise RuntimeError(f"raster_kernel not found in {old}")
        # the body cannot be launched: drop the earlier entry point
        text = text[:text.index("template <int PPT>\nstatic void launch(")]
        text += _PROBE_TAIL
    lib = ctypes.CDLL(str(_compile(
        "old_raster_probe" if probe else "old_raster", text)))
    if probe:
        # no ppt (4) and no stream; the stamps last
        lib.probe_raster.argtypes = _OLD_RASTER[:-2] + [_P]
        lib.probe_raster.restype = ctypes.c_int
    else:
        lib.splat_rasterize.argtypes = _OLD_RASTER
        lib.splat_rasterize.restype = ctypes.c_int
    return lib


def load_old_expand(old: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_compile("old_expand", old.read_text())))
    lib.splat_expand_pairs.argtypes = _OLD_EXPAND
    lib.splat_expand_pairs.restype = ctypes.c_int
    return lib


def old_raster(lib, bins, h, w, cfg, times=None):
    """The earlier K2 (3 channels, 4 pixels a thread) on ``bins``."""
    out = torch.empty((h, w, 3), dtype=torch.float32,
                      device=bins.features.device)
    nt = bins.tiles_x * bins.tiles_y
    bg = [float(c) for c in cfg.background]
    args = (bins.tile_start.data_ptr(), bins.tile_end.data_ptr(),
            bins.features.data_ptr(), bins.features.shape[1], out.data_ptr(),
            h, w, cfg.tile_w, cfg.tile_h, bins.tiles_x, nt, cfg.chunk,
            cfg.alpha_clamp, cfg.alpha_min, bg[0], bg[1], bg[2], 3,
            int(math.isfinite(cfg.sigma_cutoff)))
    if times is None:
        err = lib.splat_rasterize(*args, 4,
                                  torch.cuda.current_stream().cuda_stream)
    else:
        err = lib.probe_raster(*args, times.data_ptr())
    if err:
        raise RuntimeError(f"old K2: CUDA error {err}")
    return out


def old_expand(lib, first_slot, tx0, ty0, span_w, depth_bits, total, *,
               k_cap: int, ntx: int, num_tiles: int, cull=None,
               tile_wh=None):
    """The earlier K1, with the arguments of ``expand_pair_keys`` (it has
    no cull)."""
    if cull is not None:
        raise ValueError("the earlier K1 has no cull")
    keys = torch.empty((k_cap,), dtype=torch.int64, device=first_slot.device)
    owners = torch.empty_like(keys)
    err = lib.splat_expand_pairs(
        first_slot.data_ptr(), tx0.data_ptr(), ty0.data_ptr(),
        span_w.data_ptr(), depth_bits.data_ptr(), total.data_ptr(),
        first_slot.shape[0], k_cap, ntx, num_tiles, keys.data_ptr(),
        owners.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old K1: CUDA error {err}")
    return keys, owners


def _walk_stats(walked, pairs) -> dict:
    top = int(torch.argmax(pairs))
    return {"pairs": int(pairs.sum()), "walked": int(walked.sum()),
            "pairs_max": int(pairs.max()),
            "walked_of_heaviest": int(walked[top]),
            "walked_max": int(walked.max()),
            "walked_p99": float(torch.quantile(walked.double(), 0.99)),
            "walked_mean": float(walked.double().mean()),
            "tiles_walked_to_the_end": int((walked == pairs).sum()),
            "tiles": pairs.numel()}


def probe(old: pathlib.Path) -> None:
    from splat_tpu_torch.render.kernels import rasterize_tiles_plain
    dev = torch.device("cuda", 0)
    lib = load_old_raster(old, probe=False)
    stamped = load_old_raster(old, probe=True)
    tp.current_registers("raster.cu")
    for kind in ("random", "surface"):
        bins, cfg, h, w = tp.frame(kind, dev)
        nt = bins.tiles_x * bins.tiles_y
        times = torch.zeros((nt, 3), dtype=torch.int64, device=dev)
        img = old_raster(lib, bins, h, w, cfg)
        old_raster(stamped, bins, h, w, cfg, times=times)
        torch.cuda.synchronize()
        img_p, walked = rasterize_tiles_plain(bins, h, w, cfg,
                                              return_walked=True)
        pairs = (bins.tile_end - bins.tile_start).long()
        rec = {"frame": kind, **_walk_stats(walked, pairs),
               "old_max_abs_err": float((img - img_p).abs().max()),
               "k2_probe": tp._block_stats(times, walked)}
        # the kernel with every tile but the one that walks longest emptied
        heavy = int(torch.argmax(walked))
        keep = torch.zeros(nt, dtype=torch.bool, device=dev)
        keep[heavy] = True
        one = dataclasses.replace(bins, tile_end=torch.where(
            keep, bins.tile_end, bins.tile_start))
        rec["k2_heaviest_only_ms"] = tp._events_ms(
            lambda: old_raster(lib, one, h, w, cfg), 5)
        rec["k2_ms"] = tp._events_ms(
            lambda: old_raster(lib, bins, h, w, cfg), 10)
        wend = bins.tile_start.long() + walked
        for rows in (4, 1):
            hits = tp.strip_hits(bins, cfg, wend, rows)
            nstrip = hits.shape[1]
            rec[f"strips_{rows}row"] = {
                "hit_share": float(hits.sum() / (walked.sum() * nstrip)),
                "heaviest_max_strip_hits": int(hits[heavy].max()),
                "heaviest_mean_strip_hits": float(hits[heavy].double()
                                                  .mean()),
            }
        print(json.dumps(rec), flush=True)


def stamp() -> None:
    from splat_tpu_torch.render import plan
    from splat_tpu_torch.render.kernels import (rasterize_tiles,
                                                rasterize_tiles_plain)
    dev = torch.device("cuda", 0)
    real = _build.library()               # K1 builds the bins
    lib = tp.load_stamped_current("raster.cu", RASTER_ENTRIES)
    for kind in ("random", "surface"):
        bins, cfg, h, w = tp.frame(kind, dev)
        nt = bins.tiles_x * bins.tiles_y
        times = torch.zeros((nt * plan.SPLIT_BLOCKS, 6), dtype=torch.int64,
                            device=dev)
        if lib.probe_set_times(times.data_ptr()):
            raise RuntimeError("probe_set_times failed")
        _build._lib = lib
        try:
            rasterize_tiles(bins, h, w, cfg)    # warm-up, then the stamps
            times.zero_()
            rasterize_tiles(bins, h, w, cfg)
        finally:
            _build._lib = real
        torch.cuda.synchronize()
        _, walked = rasterize_tiles_plain(bins, h, w, cfg,
                                          return_walked=True)
        pairs = (bins.tile_end - bins.tile_start).long()
        # the heaviest tile by pairs held (what the plan splits on), and
        # the one that walks longest
        rec = {"frame": kind, "split_tiles": int(rasterize_tiles.split_tiles),
               **_walk_stats(walked, pairs),
               "by_pairs": tp._stamp_stats(times, pairs),
               "by_walk": tp._stamp_stats(times, walked)}
        print(json.dumps(rec), flush=True)


# variants of the current K2 source: (name, {old text: new text})
_LAUNCH_BOUNDS = "__global__ void __launch_bounds__(THREADS) raster_kernel("
_VARIANTS = (
    ("blocks_4", {_LAUNCH_BOUNDS: "__global__ void __launch_bounds__("
                                  "THREADS, 4) raster_kernel("}),
    ("blocks_5", {_LAUNCH_BOUNDS: "__global__ void __launch_bounds__("
                                  "THREADS, 5) raster_kernel("}),
    # the grouped walk's 4-px kernel at the registers it wants (80: 3
    # blocks an SM)
    ("subtile_blocks_3", {
        "__global__ void __launch_bounds__(THREADS, 4) raster_kernel_subtile4(":
            "__global__ void __launch_bounds__(THREADS) "
            "raster_kernel_subtile4("}),
    # every staged pair walked by every warp: what the strip test saves
    ("no_strip_skip", {
        "ql < hi && (!a.use_bbox || strip_reaches(st, smem[3 * ql])));":
            "ql < hi);"}),
    # the exit voted by each block alone: what the votes across the cluster
    # cost (wrong images where a split tile exits early; a timing only)
    ("no_cluster_vote", {
        "    if constexpr (VOTES) {\n      // The tile goes on":
            "    if constexpr (false) {\n      // The tile goes on"}),
    # the votes as a release store and acquire loads at cluster scope: what
    # their fences cost
    ("release_acquire_votes", {
        "st.relaxed.cluster.b32": "st.release.cluster.b32",
        "ld.relaxed.cluster.b32": "ld.acquire.cluster.b32"}),
    # each batch staged in one part (right for chunk <= STAGE_PAIRS): what
    # the loop over a batch's parts costs
    ("one_stage_part", {
        "#pragma unroll 1\n    for (int k0 = max(s, kb); k0 < b_end; "
        "k0 += STAGE_PAIRS) {": "    {\n      const int k0 = max(s, kb);"}),
)


def _plan_cost(bins, ppt: int = 4, reps: int = 50) -> dict:
    """Device and host milliseconds of one work list built by PyTorch calls
    (``_tile_plan``, the plain version of the plan kernel; the kernel's
    own time is inside K2's)."""
    from splat_tpu_torch.render import plan
    dev = bins.features.device

    def run():
        return plan._tile_plan(bins.tile_end.to(torch.int64)
                               - bins.tile_start, plan._split(ppt),
                               plan._slots(dev))

    device_ms = tp._events_ms(run, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return {"torch_plan_device_ms": device_ms,
            "torch_plan_host_enqueue_ms": host_ms}


def load_source(name: str, path: pathlib.Path) -> ctypes.CDLL:
    """Another K2 source with the current argument list, bound as _build
    binds the port's."""
    return tp._bind(_compile(f"source_{name}", path.read_text()),
                    RASTER_ENTRIES)


def tune(thresholds, sources, variants=None, subtile: bool = False) -> None:
    from splat_tpu_torch.render import plan
    from splat_tpu_torch.render.kernels import rasterize_tiles
    dev = torch.device("cuda", 0)
    real = _build.library()
    libs = {"current": real}
    for name, subs in _VARIANTS:
        if variants is None or name in variants:
            libs[name] = tp.load_variant(name, subs, "raster.cu",
                                         RASTER_ENTRIES)
    for spec in sources:
        name, path = spec.split("=", 1)
        libs[name] = load_source(name, pathlib.Path(path))
    default = plan.SPLIT_MIN_PAIRS
    for kind in ("random", "surface"):
        bins, cfg, h, w = tp.frame(kind, dev)
        # the pairs do not depend on the exit: the same bins either way
        cfg = dataclasses.replace(cfg, subtile_exit=subtile)

        def timed(lib, thr):
            _build._lib = lib
            plan.SPLIT_MIN_PAIRS = thr
            try:
                ms = tp._events_ms(lambda: rasterize_tiles(bins, h, w, cfg),
                                   10)
                split = int(rasterize_tiles.split_tiles)
            finally:
                _build._lib = real
                plan.SPLIT_MIN_PAIRS = default
            return ms, split

        runs = [(name, default) for name in libs] + [
            ("current", t) for t in thresholds if t != default]
        rec = {"frame": kind, "subtile_exit": subtile, **_plan_cost(bins)}
        for name, thr in runs + runs[::-1]:     # in turns, there and back
            rec.setdefault(f"{name}@{thr}", []).append(timed(libs[name], thr))
        print(json.dumps(rec), flush=True)


def _in_turns(old_fn, new_fn, rounds: int, reps: int):
    seq = []
    for _ in range(rounds):
        seq += [("old", tp._events_ms(old_fn, reps)),
                ("new", tp._events_ms(new_fn, reps)),
                ("new", tp._events_ms(new_fn, reps)),
                ("old", tp._events_ms(old_fn, reps))]
    return ([t for who, t in seq if who == "old"],
            [t for who, t in seq if who == "new"])


def compare(old_raster_src: pathlib.Path, old_expand_src: pathlib.Path,
            rounds: int, frames: int) -> None:
    """Earlier against current K2 and K1, in turns, on both frames; then
    the frame sweep with the earlier and with the current kernels."""
    from splat_tpu_torch.ops.projection import project_gaussians
    from splat_tpu_torch.render import binning, tiled
    from splat_tpu_torch.render.expand import expand_pair_keys
    from splat_tpu_torch.render.kernels import rasterize_tiles
    from splat_tpu_torch.utils.benchmark import chained_bench

    dev = torch.device("cuda", 0)
    lib2 = load_old_raster(old_raster_src, probe=False)
    lib1 = load_old_expand(old_expand_src)
    tp.current_registers("raster.cu")
    tp.current_registers("expand.cu")
    expand_old = functools.partial(old_expand, lib1)
    for kind in ("random", "surface"):
        scene, cfg, cam = tp.scene_of(kind, dev)
        h, w = cam.h, cam.w
        proj = project_gaussians(scene, cam, cfg)
        lay = binning.slot_layout(proj, h, w, cfg)
        bins = binning.build_tile_bins(proj, h, w, cfg)
        img_old = old_raster(lib2, bins, h, w, cfg)
        img_new = rasterize_tiles(bins, h, w, cfg)
        k_old, o_old = lay.expand(expand_old)
        k_new, o_new = lay.expand()
        torch.cuda.synchronize()
        rec = {"frame": kind, "pairs": int(bins.num_pairs),
               "k2_max_abs_diff_old_new": float((img_old - img_new).abs()
                                                .max()),
               "k2_split_tiles": int(rasterize_tiles.split_tiles),
               "k1_same_as_old": bool(torch.equal(k_old, k_new)
                                      and torch.equal(o_old, o_new)),
               **_plan_cost(bins)}
        rec["k2_old_ms"], rec["k2_new_ms"] = _in_turns(
            lambda: old_raster(lib2, bins, h, w, cfg),
            lambda: rasterize_tiles(bins, h, w, cfg), rounds, 10)
        rec["k1_old_ms"], rec["k1_new_ms"] = _in_turns(
            lambda: lay.expand(expand_old), lay.expand, rounds, 20)

        def sweep(old: bool):
            # the entry points look both kernels up in their modules
            if old:
                tiled.rasterize_tiles = functools.partial(old_raster, lib2)
                binning.expand_pair_keys = expand_old
            try:
                r = chained_bench(scene, cam, cfg, frames)
            finally:
                tiled.rasterize_tiles = rasterize_tiles
                binning.expand_pair_keys = expand_pair_keys
            if r["overflow"]:
                raise RuntimeError(f"{kind}: overflow {r['overflow']}")
            return r["ms_per_frame"]

        seq = [(who, sweep(who == "old")) for who in
               ("old", "new", "new", "old") * rounds]
        rec["frame_old_ms"] = [t for who, t in seq if who == "old"]
        rec["frame_new_ms"] = [t for who, t in seq if who == "new"]
        print(json.dumps(rec), flush=True)
        del scene, proj, lay, bins


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("probe", "stamp", "tune", "compare"))
    ap.add_argument("--old-raster", type=pathlib.Path)
    ap.add_argument("--old-expand", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--thresholds", type=int, nargs="*",
                    default=[2048, 8192, 16384])
    ap.add_argument("--sources", nargs="*", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--variants", nargs="*", default=None,
                    help="tune: build only these source variants")
    ap.add_argument("--subtile", action="store_true",
                    help="tune: time K2 with subtile_exit on")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("raster_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    if args.what == "probe":
        probe(args.old_raster)
    elif args.what == "stamp":
        stamp()
    elif args.what == "tune":
        tune(args.thresholds, args.sources, args.variants, args.subtile)
    else:
        compare(args.old_raster, args.old_expand, args.rounds, args.frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
