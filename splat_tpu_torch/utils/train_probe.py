"""Where the training kernels (K3, K4) spend their time, on one card.

    python -m splat_tpu_torch.utils.train_probe probe --old OLD.cu
    python -m splat_tpu_torch.utils.train_probe stamp
    python -m splat_tpu_torch.utils.train_probe tune
    python -m splat_tpu_torch.utils.train_probe compare --old OLD.cu

``OLD.cu`` is an earlier ``csrc/raster_train.cu`` (for example one taken
from git history into the gitignored ``build/``).  It is compiled on its
own into ``build/probe/`` and called through its C entry points, which
keep the earlier argument list.

* ``probe`` instruments the earlier source: each block records its start,
  its end (``%globaltimer``) and its SM.  At the random and the surface
  1M @1080p frames it prints, for K3 and K4, the kernel span, the heaviest
  tile's block time, the per-pair rate of heavy and light blocks, the
  kernel time with every tile but the heaviest emptied, and per warp strip
  how many walked pairs pass the bbox test (the work a warp-uniform skip
  leaves).
* ``stamp`` instruments the current source the same way (one stamp per
  block, with its tile and pixel group) and runs it through the wrappers
  of ``render/diff.py``: the span, when the split tiles' blocks start and
  end, and how busy the SMs are.
* ``tune`` times the current kernels against variants of the current
  source (a register cap per kernel through ``__launch_bounds__``) and
  against other split thresholds, on both frames, in turns.
* ``compare`` times the earlier kernels against the current ones on both
  frames, in turns (old, new, new, old), with CUDA events.

Registers and spills of both sources (``nvcc -Xptxas -v``) are printed
first.  One JSON object per frame goes to stdout.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import pathlib
import re
import subprocess

import torch

from splat_tpu_torch import _build

PROBE_DIR = _build.BUILD_DIR.parent / "probe"
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# the C entry points of the earlier source (its argument list)
_OLD_FWD = [_P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
            _I, _F, _I, _I, _I, _P]
_OLD_BWD = [_P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _I, _F, _F, _I, _I, _I, _P]

_PROBE_TAIL = r"""
__device__ __forceinline__ long long probe_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void probe_stamp(long long* times, long long t0) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    times[3 * blockIdx.x] = t0;
    times[3 * blockIdx.x + 1] = probe_now();
    times[3 * blockIdx.x + 2] = sm;
  }
}
__global__ void __launch_bounds__(256) probe_fwd_kernel(
    const int32_t* ts, const int32_t* te, const float* feats, int64_t kp,
    float* oc, float* olt, int32_t* ocut, int H, int W, int tile_w,
    int tile_h, int tiles_x, int chunk, float alpha_clamp, float alpha_min,
    int log_cap, float sat_cut_log, int sat_exit, int use_bbox,
    long long* times) {
  const long long t0 = probe_now();
  train_fwd_body<4>(ts, te, feats, kp, oc, olt, ocut, H, W, tile_w, tile_h,
                    tiles_x, chunk, alpha_clamp, alpha_min, log_cap,
                    sat_cut_log, sat_exit, use_bbox);
  probe_stamp(times, t0);
}
__global__ void __launch_bounds__(256) probe_bwd_kernel(
    const int32_t* ts, const int32_t* te, const int32_t* cut,
    const float* feats, int64_t kp, const int64_t* ranks, const float* g_c,
    const float* g_lt, const float* lt, float* out, int H, int W, int tile_w,
    int tile_h, int tiles_x, int chunk, float alpha_clamp, float alpha_min,
    int log_cap, int use_bbox, long long* times) {
  const long long t0 = probe_now();
  train_bwd_body<4>(ts, te, cut, feats, kp, ranks, g_c, g_lt, lt, out, H, W,
                    tile_w, tile_h, tiles_x, chunk, alpha_clamp, alpha_min,
                    log_cap, use_bbox);
  probe_stamp(times, t0);
}
extern "C" int probe_fwd(const void* ts, const void* te, const void* feats,
    int64_t kp, void* oc, void* olt, void* ocut, int H, int W, int tile_w,
    int tile_h, int tiles_x, int num_tiles, int chunk, float alpha_clamp,
    float alpha_min, int log_cap, float sat_cut_log, int sat_exit,
    int use_bbox, void* times) {
  probe_fwd_kernel<<<num_tiles, 256, (size_t)TNF * chunk * sizeof(float)>>>(
      (const int32_t*)ts, (const int32_t*)te, (const float*)feats, kp,
      (float*)oc, (float*)olt, (int32_t*)ocut, H, W, tile_w, tile_h, tiles_x,
      chunk, alpha_clamp, alpha_min, log_cap, sat_cut_log, sat_exit,
      use_bbox, (long long*)times);
  return (int)cudaGetLastError();
}
extern "C" int probe_bwd(const void* ts, const void* te, const void* cut,
    const void* feats, int64_t kp, const void* ranks, const void* g_c,
    const void* g_lt, const void* lt, void* out, int H, int W, int tile_w,
    int tile_h, int tiles_x, int num_tiles, int chunk, float alpha_clamp,
    float alpha_min, int log_cap, int use_bbox, void* times) {
  probe_bwd_kernel<<<num_tiles, 256>>>(
      (const int32_t*)ts, (const int32_t*)te, (const int32_t*)cut,
      (const float*)feats, kp, (const int64_t*)ranks, (const float*)g_c,
      (const float*)g_lt, (const float*)lt, (float*)out, H, W, tile_w,
      tile_h, tiles_x, chunk, alpha_clamp, alpha_min, log_cap, use_bbox,
      (long long*)times);
  return (int)cudaGetLastError();
}
"""


def _nvcc(src: pathlib.Path, out: pathlib.Path, verbose: bool) -> str:
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)] + (["-Xptxas", "-v"] if verbose else [])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    return res.stderr


def _registers(log: str) -> list[str]:
    """'kernel: N registers, spills' lines of an -Xptxas -v log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.append(f"{name}: spills {m.group(1)}/{m.group(2)} B")
    return out


def load_old(old: pathlib.Path, probe: bool) -> ctypes.CDLL:
    """The earlier source as its own library (instrumented with probe)."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    text = old.read_text()
    if probe:
        for kind in ("fwd", "bwd"):
            text, n = re.subn(
                r"__global__ void __launch_bounds__\(256\) "
                rf"train_{kind}_kernel\(",
                f"__device__ __forceinline__ void train_{kind}_body(", text)
            if n != 1:
                raise RuntimeError(f"train_{kind}_kernel not found in {old}")
        text = text.replace("train_fwd_kernel<", "train_fwd_body<")
        text = text.replace("train_bwd_kernel<", "train_bwd_body<")
        # the body cannot be launched: drop the earlier entry points
        text = text[:text.index('extern "C" int splat_rasterize_train_fwd')]
        text += _PROBE_TAIL
    src = PROBE_DIR / ("old_probe.cu" if probe else "old.cu")
    src.write_text(text)
    lib_path = src.with_suffix(".so")
    log = _nvcc(src, lib_path, verbose=True)
    print(f"[regs] {src.name}: " + "; ".join(_registers(log)), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    if probe:
        # no ppt (4) and no stream; the stamps last
        lib.probe_fwd.argtypes = _OLD_FWD[:-2] + [_P]
        lib.probe_bwd.argtypes = _OLD_BWD[:-2] + [_P]
        lib.probe_fwd.restype = lib.probe_bwd.restype = ctypes.c_int
    else:
        lib.splat_rasterize_train_fwd.argtypes = _OLD_FWD
        lib.splat_rasterize_train_bwd.argtypes = _OLD_BWD
        lib.splat_rasterize_train_fwd.restype = ctypes.c_int
        lib.splat_rasterize_train_bwd.restype = ctypes.c_int
    return lib


def current_registers() -> None:
    src = _build.CSRC / "raster_train.cu"
    log = _nvcc(src, PROBE_DIR / "current.so", verbose=True)
    print("[regs] current raster_train.cu: " + "; ".join(_registers(log)),
          flush=True)


def frame(kind: str, dev):
    """Bins of the 1M @1080p frames of chip_smoke.py."""
    from splat_tpu_torch.camera import Camera
    from splat_tpu_torch.config import RenderConfig
    from splat_tpu_torch.ops.projection import project_gaussians
    from splat_tpu_torch.render.binning import build_tile_bins
    from splat_tpu_torch.utils.fixtures import random_scene, surface_scene

    if kind == "surface":
        scene, dup = surface_scene(1_000_000, seed=0, device=dev), 1.45
    else:
        scene = random_scene(1_000_000, seed=0, extent=3.0,
                             scale_range=(0.004, 0.03), device=dev)
        dup = 2.05
    cfg = RenderConfig(max_dup_factor=dup)
    cam = Camera.create(h=1080, w=1920, position=(0.0, 0.0, 4.0), device=dev)
    bins = build_tile_bins(project_gaussians(scene, cam, cfg), 1080, 1920,
                           cfg)
    return bins, cfg, 1080, 1920


def walk_end(bins, cfg, cut):
    """Per tile: one past the last pair K3 and K4 walk."""
    from splat_tpu_torch.render.diff import _walk_end
    return _walk_end(bins, cfg.chunk, cut)


def strip_hits(bins, cfg, wend, rows: int):
    """Per tile and strip of ``rows`` tile rows: walked pairs whose bbox
    reaches some pixel of the strip (float test at the nearest pixel)."""
    s = bins.tile_start.long()
    n = torch.clamp(wend - s, min=0)
    nt = n.numel()
    tid = torch.repeat_interleave(torch.arange(nt, device=s.device), n)
    off = torch.arange(int(n.sum()), device=s.device) - (
        torch.repeat_interleave(torch.cumsum(n, 0) - n, n))
    k = s[tid] + off
    f = bins.features[:, k]
    cx, cy, rx2, ry2 = f[0], f[1], f[9], f[10]
    tw, th = cfg.tile_w, cfg.tile_h
    x0 = (tid % bins.tiles_x * tw).float()
    y0 = (tid // bins.tiles_x * th).float()

    def near(c, lo, hi):
        a = torch.minimum(torch.maximum(torch.floor(c), lo), hi)
        b = torch.minimum(torch.maximum(torch.floor(c) + 1, lo), hi)
        return torch.minimum((a - c) ** 2, (b - c) ** 2)

    okx = near(cx, x0, x0 + tw - 1) <= rx2
    nstrip = th // rows
    hits = torch.zeros((nt, nstrip), dtype=torch.int64, device=s.device)
    for j in range(nstrip):
        oky = near(cy, y0 + j * rows, y0 + (j + 1) * rows - 1) <= ry2
        hits[:, j].index_add_(0, tid, (okx & oky).long())
    return hits


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _old_args(bins, cfg, h, w, ppt=4):
    from splat_tpu_torch.render.diff import _log_cap
    nt = bins.tiles_x * bins.tiles_y
    return dict(nt=nt, kp=bins.features.shape[1],
                common=(h, w, cfg.tile_w, cfg.tile_h, bins.tiles_x, nt,
                        cfg.chunk, cfg.alpha_clamp, cfg.alpha_min,
                        int(_log_cap(cfg) is not None)),
                bbox=int(math.isfinite(cfg.sigma_cutoff)), ppt=ppt)


def old_fwd(lib, bins, cfg, h, w, out, times=None, sat_cut_log=-105.0):
    a = _old_args(bins, cfg, h, w)
    c, lt, cut = out
    ptrs = (bins.tile_start.data_ptr(), bins.tile_end.data_ptr(),
            bins.features.data_ptr(), a["kp"], c.data_ptr(), lt.data_ptr(),
            cut.data_ptr())
    tail = (float(sat_cut_log), int(cfg.train_sat_exit), a["bbox"])
    if times is None:
        err = lib.splat_rasterize_train_fwd(
            *ptrs, *a["common"], *tail, a["ppt"],
            torch.cuda.current_stream().cuda_stream)
    else:
        err = lib.probe_fwd(*ptrs, *a["common"], *tail, times.data_ptr())
    if err:
        raise RuntimeError(f"old K3: CUDA error {err}")


def old_bwd(lib, bins, cfg, h, w, g_c, g_lt, lt, cut, out, times=None):
    a = _old_args(bins, cfg, h, w)
    ptrs = (bins.tile_start.data_ptr(), bins.tile_end.data_ptr(),
            cut.data_ptr(), bins.features.data_ptr(), a["kp"],
            bins.ranks.data_ptr(), g_c.data_ptr(), g_lt.data_ptr(),
            lt.data_ptr(), out.data_ptr())
    if times is None:
        err = lib.splat_rasterize_train_bwd(
            *ptrs, *a["common"], a["bbox"], a["ppt"],
            torch.cuda.current_stream().cuda_stream)
    else:
        err = lib.probe_bwd(*ptrs, *a["common"], a["bbox"], times.data_ptr())
    if err:
        raise RuntimeError(f"old K4: CUDA error {err}")


def _block_stats(times, walk):
    """Span and per-block figures from (T, 3) start/end/SM stamps."""
    t = times.double().cpu()
    start, end = t[:, 0], t[:, 1]
    t0 = float(start.min())
    dur = (end - start) / 1e6                                 # ms
    span = (float(end.max()) - t0) / 1e6
    walk = walk.double().cpu()
    heavy = int(torch.argmax(walk))
    busy = walk > 0
    rate = dur[busy] / walk[busy] * 1e6                        # ns / pair
    light = busy & (walk <= torch.quantile(walk[busy], 0.5))
    ends = torch.sort((end - t0) / 1e6)[0]
    return {
        "span_ms": span,
        "heaviest_tile": heavy, "heaviest_walk": int(walk[heavy]),
        "heaviest_block_ms": float(dur[heavy]),
        "heaviest_starts_ms": float((start[heavy] - t0) / 1e6),
        "ns_per_pair_heaviest": float(dur[heavy] / walk[heavy] * 1e6),
        "ns_per_pair_median_all": float(rate.median()),
        "ns_per_pair_median_light_half": float(
            (dur[light] / walk[light] * 1e6).median()),
        "blocks_done_at_ms": {q: float(ends[int(q * (len(ends) - 1))])
                              for q in (0.5, 0.9, 0.99)},
        "sum_block_ms_over_span": float(dur.sum() / span),
        "sms_used": int(torch.unique(t[:, 2]).numel()),
    }


def probe(old: pathlib.Path) -> None:
    dev = torch.device("cuda", 0)
    lib = load_old(old, probe=False)
    stamped = load_old(old, probe=True)
    current_registers()
    for kind in ("random", "surface"):
        bins, cfg, h, w = frame(kind, dev)
        nt = bins.tiles_x * bins.tiles_y
        out = (torch.empty((h, w, 3), device=dev),
               torch.empty((h, w), device=dev),
               torch.empty((nt,), dtype=torch.int32, device=dev))
        times = torch.zeros((nt, 3), dtype=torch.int64, device=dev)
        old_fwd(lib, bins, cfg, h, w, out)
        old_fwd(stamped, bins, cfg, h, w, out, times=times)
        torch.cuda.synchronize()
        c, lt, cut = out
        wend = walk_end(bins, cfg, cut)
        walk = torch.clamp(wend - bins.tile_start.long(), min=0)
        rec = {"frame": kind, "pairs": int(bins.num_pairs), "tiles": nt,
               "walk_max": int(walk.max()),
               "walk_p99": float(torch.quantile(walk.double(), 0.99)),
               "walk_mean": float(walk.double().mean()),
               "k3_probe": _block_stats(times[:, :], walk)}
        gen = torch.Generator(device=dev).manual_seed(0)
        g_c = torch.randn((h, w, 3), generator=gen, device=dev)
        g_lt = torch.randn((h, w), generator=gen, device=dev)
        g = torch.zeros((bins.num_gaussians, 9), device=dev)
        old_bwd(stamped, bins, cfg, h, w, g_c, g_lt, lt, cut, g, times=times)
        torch.cuda.synchronize()
        rec["k4_probe"] = _block_stats(times, walk)
        # the kernel with every tile but the heaviest emptied
        heavy = int(torch.argmax(walk))
        keep = torch.zeros(nt, dtype=torch.bool, device=dev)
        keep[heavy] = True
        one = dataclasses.replace(bins, tile_end=torch.where(
            keep, bins.tile_end, bins.tile_start))
        rec["k3_heaviest_only_ms"] = _events_ms(
            lambda: old_fwd(lib, one, cfg, h, w, out), 3)
        c1, lt1, cut1 = out
        rec["k4_heaviest_only_ms"] = _events_ms(
            lambda: old_bwd(lib, one, cfg, h, w, g_c, g_lt, lt1, cut1, g), 3)
        old_fwd(lib, bins, cfg, h, w, out)     # restore the full frame
        rec["k3_ms"] = _events_ms(lambda: old_fwd(lib, bins, cfg, h, w,
                                                  out), 5)
        rec["k4_ms"] = _events_ms(lambda: old_bwd(lib, bins, cfg, h, w, g_c,
                                                  g_lt, lt, cut, g), 5)
        for rows in (4, 1):
            hits = strip_hits(bins, cfg, wend, rows)
            nstrip = hits.shape[1]
            rec[f"strips_{rows}row"] = {
                "hit_share": float(hits.sum() / (walk.sum() * nstrip)),
                "heaviest_max_strip_hits": int(hits[heavy].max()),
                "heaviest_mean_strip_hits": float(hits[heavy].double()
                                                  .mean()),
                "max_strip_hits_any_tile": int(hits.max()),
            }
        print(json.dumps(rec), flush=True)

_STAMP_HEAD = r"""
__device__ long long* probe_times;
struct ProbeStamp {
  long long t0;
  int tile, group, split;
  __device__ ProbeStamp(int t, int g, int n) : tile(t), group(g), split(n) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  }
  __device__ ~ProbeStamp() {
    if (threadIdx.x != 0) return;
    long long t1;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    long long* o = probe_times + 6 * blockIdx.x;
    o[0] = t0; o[1] = t1; o[2] = sm; o[3] = tile; o[4] = group;
    o[5] = split;
  }
};
extern "C" int probe_set_times(void* p) {
  return (int)cudaMemcpyToSymbol(probe_times, &p, sizeof(p));
}
"""


def load_stamped_current() -> ctypes.CDLL:
    """The current source with a stamp per block, bound as _build binds
    the library, so the wrappers of render/diff.py can call it."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "raster_train.cu").read_text()
    hook = "  if (!work_of(order, nheavy, num_tiles, S, &w)) return;\n"
    if text.count(hook) != 2:
        raise RuntimeError("work_of() call sites not found")
    text = text.replace(hook, hook + "  ProbeStamp probe_stamp_(w.tile, "
                        "w.group, w.split);\n")
    text = text.replace("struct Work {", _STAMP_HEAD + "struct Work {", 1)
    src = PROBE_DIR / "current_stamped.cu"
    src.write_text(text)
    lib_path = src.with_suffix(".so")
    _nvcc(src, lib_path, verbose=False)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("splat_rasterize_train_fwd", "splat_rasterize_train_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.probe_set_times.argtypes = [_P]
    lib.probe_set_times.restype = ctypes.c_int
    return lib


def _stamp_stats(times, walk) -> dict:
    t = times.double().cpu()
    used = t[:, 1] > 0
    t = t[used]
    t0 = float(t[:, 0].min())
    start, end = (t[:, 0] - t0) / 1e6, (t[:, 1] - t0) / 1e6
    dur = end - start
    span = float(end.max())
    tile = t[:, 3].long()
    walk = walk.double().cpu()
    heavy = t[:, 5] > 1
    ends = torch.sort(end)[0]
    out = {"span_ms": span, "blocks": int(used.sum()),
           "split_blocks": int(heavy.sum()),
           "sum_block_ms_over_span": float(dur.sum() / span),
           "blocks_done_at_ms": {q: float(ends[int(q * (len(ends) - 1))])
                                 for q in (0.5, 0.9, 0.99)},
           "light_ms_max": float(dur[~heavy].max()) if (~heavy).any()
           else 0.0,
           "light_end_ms_max": float(end[~heavy].max()) if (~heavy).any()
           else 0.0}
    top = int(torch.argmax(walk))
    mine = tile == top
    out.update({"heaviest_walk": int(walk[top]),
                "heaviest_blocks_start_ms": start[mine].tolist(),
                "heaviest_blocks_ms": dur[mine].tolist()})
    if heavy.any():
        out.update({"split_end_ms_max": float(end[heavy].max()),
                    "split_ms_sum": float(dur[heavy].sum())})
    return out


def stamp() -> None:
    from splat_tpu_torch.render import diff
    dev = torch.device("cuda", 0)
    real = _build.library()               # K1 builds the bins
    lib = load_stamped_current()

    def stamped(fn, *args):
        _build._lib = lib
        try:
            fn(*args)               # warm-up, then the stamped run
            times.zero_()
            out = fn(*args)
        finally:
            _build._lib = real
        torch.cuda.synchronize()
        return out

    for kind in ("random", "surface"):
        bins, cfg, h, w = frame(kind, dev)
        nt = bins.tiles_x * bins.tiles_y
        times = torch.zeros((nt * diff.SPLIT_BLOCKS, 6), dtype=torch.int64,
                            device=dev)
        if lib.probe_set_times(times.data_ptr()):
            raise RuntimeError("probe_set_times failed")
        c, lt, cut = stamped(diff.rasterize_train_fwd, bins, h, w, cfg)
        pairs = (bins.tile_end - bins.tile_start).long()
        rec = {"frame": kind,
               "k3": _stamp_stats(times, pairs)}
        gen = torch.Generator(device=dev).manual_seed(0)
        g_c = torch.randn((h, w, 3), generator=gen, device=dev)
        g_lt = torch.randn((h, w), generator=gen, device=dev)
        stamped(diff.rasterize_train_bwd, bins, g_c, g_lt, lt, cut, h, w,
                cfg)
        walk = torch.clamp(walk_end(bins, cfg, cut) - bins.tile_start.long(),
                           min=0)
        rec["k4"] = _stamp_stats(times, walk)
        print(json.dumps(rec), flush=True)

# variants of the current source: (name, {old text: new text})
_VARIANTS = (
    # the box test before the expf, skipping it outside the box
    ("box_before_expf", {
        "  a.dy2 = __fmul_rn(a.dy, a.dy);\n":
            "  a.dy2 = __fmul_rn(a.dy, a.dy);\n"
            "  a.keep = !use_bbox || (a.dx2 <= g0.z && a.dy2 <= g0.w);\n"
            "  if (!a.keep) return a;\n",
        "  if (use_bbox) a.keep = a.keep && a.dx2 <= g0.z && a.dy2 <= g0.w;\n":
            ""}),
    ("bwd_2_blocks", {"__launch_bounds__(THREADS, PPT <= 4 ? 3 : 1)":
                      "__launch_bounds__(THREADS)"}),
    ("fwd_4_blocks", {"__global__ void __launch_bounds__(THREADS) "
                      "train_fwd_kernel(": "__global__ void "
                      "__launch_bounds__(THREADS, 4) train_fwd_kernel("}),
)


def load_variant(name: str, subs: dict) -> ctypes.CDLL:
    """The current source with ``subs`` applied, bound as _build binds it."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "raster_train.cu").read_text()
    for old, new in subs.items():
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found once")
        text = text.replace(old, new)
    src = PROBE_DIR / f"variant_{name}.cu"
    src.write_text(text)
    log = _nvcc(src, src.with_suffix(".so"), verbose=True)
    print(f"[regs] {name}: " + "; ".join(
        r for r in _registers(log) if "ILi4E" in r), flush=True)
    lib = ctypes.CDLL(str(src.with_suffix(".so")))
    for fn_name in ("splat_rasterize_train_fwd", "splat_rasterize_train_bwd"):
        fn = getattr(lib, fn_name)
        fn.argtypes = _build._SIGNATURES[fn_name]
        fn.restype = ctypes.c_int
    return lib


def tune(thresholds) -> None:
    from splat_tpu_torch.render import diff
    dev = torch.device("cuda", 0)
    real = _build.library()
    libs = {"current": real}
    for name, subs in _VARIANTS:
        libs[name] = load_variant(name, subs)
    default = diff.SPLIT_MIN_PAIRS
    for kind in ("random", "surface"):
        bins, cfg, h, w = frame(kind, dev)
        c, lt, cut = diff.rasterize_train_fwd(bins, h, w, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        g_c = torch.randn((h, w, 3), generator=gen, device=dev)
        g_lt = torch.randn((h, w), generator=gen, device=dev)

        def timed(lib, thr):
            _build._lib = lib
            diff.SPLIT_MIN_PAIRS = thr
            try:
                k3 = _events_ms(lambda: diff.rasterize_train_fwd(
                    bins, h, w, cfg), 5)
                k4 = _events_ms(lambda: diff.rasterize_train_bwd(
                    bins, g_c, g_lt, lt, cut, h, w, cfg), 5)
            finally:
                _build._lib = real
                diff.SPLIT_MIN_PAIRS = default
            return k3, k4

        runs = [(name, default) for name in libs] + [
            ("current", t) for t in thresholds if t != default]
        rec = {"frame": kind}
        for name, thr in runs + runs[::-1]:     # in turns, there and back
            k3, k4 = timed(libs[name], thr)
            rec.setdefault(f"{name}@{thr}", []).append((k3, k4))
        print(json.dumps(rec), flush=True)


def compare(old: pathlib.Path, rounds: int) -> None:
    """Earlier against current K3 and K4, in turns, on both frames."""
    from splat_tpu_torch.render import diff
    dev = torch.device("cuda", 0)
    lib = load_old(old, probe=False)
    current_registers()
    for kind in ("random", "surface"):
        bins, cfg, h, w = frame(kind, dev)
        nt = bins.tiles_x * bins.tiles_y
        out = (torch.empty((h, w, 3), device=dev),
               torch.empty((h, w), device=dev),
               torch.empty((nt,), dtype=torch.int32, device=dev))
        c, lt, cut = diff.rasterize_train_fwd(bins, h, w, cfg)
        old_fwd(lib, bins, cfg, h, w, out)
        torch.cuda.synchronize()
        same = (torch.equal(cut, out[2])
                and float((c - out[0]).abs().max()) <= 1e-4
                and float((lt - out[1]).abs().max()) <= 1e-4)
        gen = torch.Generator(device=dev).manual_seed(0)
        g_c = torch.randn((h, w, 3), generator=gen, device=dev)
        g_lt = torch.randn((h, w), generator=gen, device=dev)
        g_old = torch.zeros((bins.num_gaussians, 9), device=dev)

        def k3_old():
            old_fwd(lib, bins, cfg, h, w, out)

        def k3_new():
            diff.rasterize_train_fwd(bins, h, w, cfg)

        def k4_old():
            g_old.zero_()
            old_bwd(lib, bins, cfg, h, w, g_c, g_lt, lt, cut, g_old)

        def k4_new():
            diff.rasterize_train_bwd(bins, g_c, g_lt, lt, cut, h, w, cfg)

        rec = {"frame": kind, "k3_same_as_old": same}
        for name, old_fn, new_fn in (("k3", k3_old, k3_new),
                                     ("k4", k4_old, k4_new)):
            seq = []
            for _ in range(rounds):
                seq += [("old", _events_ms(old_fn, 5)),
                        ("new", _events_ms(new_fn, 5)),
                        ("new", _events_ms(new_fn, 5)),
                        ("old", _events_ms(old_fn, 5))]
            rec[f"{name}_old_ms"] = [t for who, t in seq if who == "old"]
            rec[f"{name}_new_ms"] = [t for who, t in seq if who == "new"]
        print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("probe", "stamp", "tune", "compare"))
    ap.add_argument("--old", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--thresholds", type=int, nargs="*",
                    default=[2048, 8192, 16384])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    if args.what == "probe":
        probe(args.old)
    elif args.what == "stamp":
        stamp()
    elif args.what == "tune":
        tune(args.thresholds)
    else:
        compare(args.old, args.rounds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
