// The training forward (K3) and backward (K4) of the tiled renderer.
//
// K3 replaces the TPU kernel splat_tpu/render/diff.py::_fwd_kernel.  It is
// K2's walk (csrc/raster.cu) without the 1/255 exit: one block of 256
// threads per tile, the tile's pixels in registers (PPT per thread), the
// pairs of each window staged through shared memory.  Per pixel and kept
// pair it carries C += alpha * T * color, T *= 1 - alpha' and
// logT += log1p(-alpha'), alpha' = min(alpha, 0.999999) when
// alpha_clamp >= 0.999999.  Windows are `chunk` pairs wide and start at
// (tile_start / 128) * 128, as the TPU's do.  After every 4th window, and
// after each window of the tail, a block vote (__syncthreads_and) asks
// whether every pixel of the tile, past the image edge included, is
// saturated: logT < sat_cut_log and T == 0 (the exact cut: later pairs add
// exact zeros to the image and to every gradient), or T < alpha_min with
// train_sat_exit.  It writes raw C (H, W, 3), logT (H, W) and the number of
// windows walked per tile.
//
// K4 replaces the TPU kernel splat_tpu/render/diff.py::_bwd_kernel.  Same
// block layout; it walks the pairs of windows [0, cut) in reverse, in
// batches of BWD_BATCH staged through shared memory.  Each pixel carries
// lt (from logT) and D (from dL/dlogT) and recomputes alpha exactly as K3
// did; for a kept pair: lt_i = lt - log1p(-alpha'), T_i = exp(min(lt_i, 0)),
// gc = sum_c dL/dC_c * color_c, dalpha = T_i * gc - D / (1 - alpha'),
// D += gc * alpha * T_i, lt = lt_i.  Nine sums over the tile's pixels per
// pair (five geometry moments of dpower, three colour sums, the opacity
// sum) are reduced within each warp by shuffles (skipped when no pixel of
// the warp kept the pair), then across the 8 warps through shared memory
// once per batch, and added with atomicAdd into the pair's gaussian row of
// an (N, 9) buffer.  That replaces the TPU's window-padded per-pair buffer,
// its gaussian-id row and the sort-and-segment-sum that followed it.
// Pixels past the image edge have zero cotangents and are skipped.
//
// Pixel layout: warp w owns the 32 * PPT consecutive tile pixels from
// w * 32 * PPT (for 32-px-wide tiles, PPT whole rows), so a warp's pixels
// are a compact strip and K4's per-warp skip fires often.
//
// Every per-pair float operation is an explicitly rounded intrinsic, in the
// order of the plain versions (splat_tpu_torch/render/diff.py), with the
// full-precision expf / log1pf, so kernel and plain version round alike;
// K4's pixel sums and atomics add in another order.
//
// What bounds them on the card: per (pixel, walked pair) one expf and
// ~14 flops to evaluate alpha, plus a log1pf and ~10 flops (K3) or an
// expf, a log1pf, a division and ~30 flops (K4) where the pair is kept.
// A pair's 44 feature bytes are shared by the tile's 1024 pixels, so both
// are bound by arithmetic, and by the longest tile walk, which runs on one
// SM while the rest of the card may idle (one block per tile, as K2).

#include <cuda_runtime.h>
#include <stdint.h>

#define TNF 11            // cx, cy, a2, b2, c2, r, g, b, opacity, rx^2, ry^2
#define WINDOW_ALIGN 128  // windows start at (tile_start / 128) * 128
#define SAT_CHECK_EVERY 4
#define ALPHA_LOG_CAP 0.999999f
#define BWD_BATCH 64
#define NWARPS 8
#define NG 9              // dcx, dcy, da2, db2, dc2, dr, dg, db, dop

struct Alpha {
  float dx, dy, dx2, dy2, expp, a_raw, alpha;
  bool keep;
};

// One pair's alpha at one pixel, as rasterize_train_fwd_plain computes it.
__device__ __forceinline__ Alpha pair_alpha(float px, float py,
                                            const float* f, float alpha_clamp,
                                            float alpha_min, int use_bbox) {
  Alpha a;
  a.dx = __fsub_rn(px, f[0]);
  a.dy = __fsub_rn(f[1], py);
  a.dx2 = __fmul_rn(a.dx, a.dx);
  a.dy2 = __fmul_rn(a.dy, a.dy);
  const float power =
      __fadd_rn(__fadd_rn(__fmul_rn(f[2], a.dx2), __fmul_rn(f[4], a.dy2)),
                __fmul_rn(f[3], __fmul_rn(a.dx, a.dy)));
  a.expp = expf(power);
  a.a_raw = __fmul_rn(f[8], a.expp);
  a.alpha = fminf(alpha_clamp, a.a_raw);
  a.keep = a.alpha >= alpha_min;
  if (use_bbox) a.keep = a.keep && a.dx2 <= f[9] && a.dy2 <= f[10];
  return a;
}

template <int PPT>
__device__ __forceinline__ int pixel_of(int i) {
  return (threadIdx.x >> 5) * 32 * PPT + i * 32 + (threadIdx.x & 31);
}

template <int PPT>
__global__ void __launch_bounds__(256) train_fwd_kernel(
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_end, const float* __restrict__ feats,
    int64_t kp, float* __restrict__ out_c, float* __restrict__ out_lt,
    int32_t* __restrict__ out_cut, int H, int W, int tile_w, int tile_h,
    int tiles_x, int chunk, float alpha_clamp, float alpha_min, int log_cap,
    float sat_cut_log, int sat_exit, int use_bbox) {
  extern __shared__ float smem[];  // [TNF][chunk]
  const int t = blockIdx.x;
  const int s = tile_start[t];
  const int e = tile_end[t];
  const int npix = tile_w * tile_h;
  const int x0 = (t % tiles_x) * tile_w;
  const int y0 = (t / tiles_x) * tile_h;

  float px[PPT], py[PPT], cr[PPT], cg[PPT], cb[PPT], tr[PPT], lt[PPT];
  bool on[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pixel_of<PPT>(i);
    on[i] = p < npix;
    px[i] = (float)(x0 + p % tile_w);
    py[i] = (float)(y0 + p / tile_w);
    cr[i] = cg[i] = cb[i] = lt[i] = 0.f;
    tr[i] = 1.f;
  }

  const int base = s - s % WINDOW_ALIGN;
  const int nch = (e - base + chunk - 1) / chunk;
  const int n_full = nch / SAT_CHECK_EVERY * SAT_CHECK_EVERY;
  int walked = 0;
  for (int j = 0; j < nch; ++j) {
    const int kb = base + j * chunk;
    __syncthreads();  // the previous window is consumed
    for (int q = threadIdx.x; q < chunk; q += blockDim.x) {
      const int k = kb + q;
      if (k >= s && k < e) {
#pragma unroll
        for (int f = 0; f < TNF; ++f) smem[f * chunk + q] = feats[f * kp + k];
      }
    }
    __syncthreads();
    const int lo = (s > kb ? s : kb) - kb;
    const int hi = (e < kb + chunk ? e : kb + chunk) - kb;
    for (int q = lo; q < hi; ++q) {
      float f[TNF];
#pragma unroll
      for (int r = 0; r < TNF; ++r) f[r] = smem[r * chunk + q];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!on[i]) continue;
        const Alpha a = pair_alpha(px[i], py[i], f, alpha_clamp, alpha_min,
                                   use_bbox);
        if (!a.keep) continue;
        const float al = log_cap ? fminf(a.alpha, ALPHA_LOG_CAP) : a.alpha;
        const float w = __fmul_rn(a.alpha, tr[i]);
        cr[i] = __fadd_rn(cr[i], __fmul_rn(w, f[5]));
        cg[i] = __fadd_rn(cg[i], __fmul_rn(w, f[6]));
        cb[i] = __fadd_rn(cb[i], __fmul_rn(w, f[7]));
        tr[i] = __fmul_rn(tr[i], __fsub_rn(1.f, al));
        lt[i] = __fadd_rn(lt[i], log1pf(-al));
      }
    }
    walked = j + 1;
    if ((walked % SAT_CHECK_EVERY == 0 && walked <= n_full) ||
        walked > n_full) {
      bool sat = true;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!on[i]) continue;
        sat = sat && (sat_exit ? tr[i] < alpha_min
                               : (lt[i] < sat_cut_log && tr[i] == 0.f));
      }
      if (__syncthreads_and(sat)) break;
    }
  }

  if (threadIdx.x == 0) out_cut[t] = walked;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pixel_of<PPT>(i);
    const int x = x0 + p % tile_w;
    const int y = y0 + p / tile_w;
    if (!on[i] || x >= W || y >= H) continue;
    const int64_t o = (int64_t)y * W + x;
    out_c[o * 3 + 0] = cr[i];
    out_c[o * 3 + 1] = cg[i];
    out_c[o * 3 + 2] = cb[i];
    out_lt[o] = lt[i];
  }
}

template <int PPT>
__global__ void __launch_bounds__(256) train_bwd_kernel(
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_end, const int32_t* __restrict__ cut,
    const float* __restrict__ feats, int64_t kp,
    const int64_t* __restrict__ ranks, const float* __restrict__ g_c,
    const float* __restrict__ g_lt, const float* __restrict__ lt_img,
    float* __restrict__ out, int H, int W, int tile_w, int tile_h,
    int tiles_x, int chunk, float alpha_clamp, float alpha_min, int log_cap,
    int use_bbox) {
  __shared__ float sf[TNF][BWD_BATCH];
  __shared__ float sred[NWARPS][BWD_BATCH][NG];
  const int t = blockIdx.x;
  const int s = tile_start[t];
  const int e = tile_end[t];
  const int base = s - s % WINDOW_ALIGN;
  const int nch = (e - base + chunk - 1) / chunk;
  const int c = cut[t] < nch ? cut[t] : nch;
  const int walk_end = e < base + c * chunk ? e : base + c * chunk;
  if (walk_end <= s) return;  // uniform over the block
  const int npix = tile_w * tile_h;
  const int x0 = (t % tiles_x) * tile_w;
  const int y0 = (t / tiles_x) * tile_h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[PPT], py[PPT], gr[PPT], gg[PPT], gb[PPT], dd[PPT], ll[PPT];
  bool on[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pixel_of<PPT>(i);
    const int x = x0 + p % tile_w;
    const int y = y0 + p / tile_w;
    on[i] = p < npix && x < W && y < H;
    px[i] = (float)x;
    py[i] = (float)y;
    const int64_t o = on[i] ? (int64_t)y * W + x : 0;
    gr[i] = on[i] ? g_c[o * 3 + 0] : 0.f;
    gg[i] = on[i] ? g_c[o * 3 + 1] : 0.f;
    gb[i] = on[i] ? g_c[o * 3 + 2] : 0.f;
    dd[i] = on[i] ? g_lt[o] : 0.f;
    ll[i] = on[i] ? lt_img[o] : 0.f;
  }

  for (int hi = walk_end; hi > s; hi -= BWD_BATCH) {
    const int lo = hi - BWD_BATCH > s ? hi - BWD_BATCH : s;
    const int nb = hi - lo;
    __syncthreads();  // the previous batch's sums are consumed
    for (int q = threadIdx.x; q < nb; q += blockDim.x) {
#pragma unroll
      for (int f = 0; f < TNF; ++f) sf[f][q] = feats[f * kp + lo + q];
    }
    __syncthreads();
    for (int q = nb - 1; q >= 0; --q) {
      float f[TNF];
#pragma unroll
      for (int r = 0; r < TNF; ++r) f[r] = sf[r][q];
      float acc[NG];
#pragma unroll
      for (int r = 0; r < NG; ++r) acc[r] = 0.f;
      bool any = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (!on[i]) continue;
        const Alpha a = pair_alpha(px[i], py[i], f, alpha_clamp, alpha_min,
                                   use_bbox);
        if (!a.keep) continue;
        any = true;
        const float al = log_cap ? fminf(a.alpha, ALPHA_LOG_CAP) : a.alpha;
        const float l_i = __fsub_rn(ll[i], log1pf(-al));
        const float t_i = expf(fminf(l_i, 0.f));
        const float gcw = __fadd_rn(
            __fadd_rn(__fmul_rn(gr[i], f[5]), __fmul_rn(gg[i], f[6])),
            __fmul_rn(gb[i], f[7]));
        const float wgt = __fmul_rn(a.alpha, t_i);
        const float da = __fsub_rn(__fmul_rn(t_i, gcw),
                                   __fdiv_rn(dd[i], __fsub_rn(1.f, al)));
        if (a.a_raw < alpha_clamp) {
          const float dp = __fmul_rn(da, a.alpha);
          acc[0] = __fadd_rn(acc[0], __fmul_rn(dp, a.dx));
          acc[1] = __fadd_rn(acc[1], __fmul_rn(dp, a.dy));
          acc[2] = __fadd_rn(acc[2], __fmul_rn(dp, a.dx2));
          acc[3] = __fadd_rn(acc[3], __fmul_rn(dp, __fmul_rn(a.dx, a.dy)));
          acc[4] = __fadd_rn(acc[4], __fmul_rn(dp, a.dy2));
          acc[8] = __fadd_rn(acc[8], __fmul_rn(da, a.expp));
        }
        acc[5] = __fadd_rn(acc[5], __fmul_rn(gr[i], wgt));
        acc[6] = __fadd_rn(acc[6], __fmul_rn(gg[i], wgt));
        acc[7] = __fadd_rn(acc[7], __fmul_rn(gb[i], wgt));
        dd[i] = __fadd_rn(dd[i], __fmul_rn(gcw, wgt));
        ll[i] = l_i;
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int r = 0; r < NG; ++r)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < NG; ++r) sred[warp][q][r] = acc[r];
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < nb; q += blockDim.x) {
      float v[NG];
      bool nz = false;
#pragma unroll
      for (int r = 0; r < NG; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) sum += sred[w][q][r];
        v[r] = sum;
        nz = nz || sum != 0.f;
      }
      if (!nz) continue;
      // power = a2 dx^2 + c2 dy^2 + b2 dx dy, dx = px - cx, dy = cy - py
      const float a2 = sf[2][q], b2 = sf[3][q], c2 = sf[4][q];
      const float g[NG] = {-(2.f * a2 * v[0] + b2 * v[1]),
                           2.f * c2 * v[1] + b2 * v[0],
                           v[2], v[3], v[4], v[5], v[6], v[7], v[8]};
      float* o = out + ranks[lo + q] * NG;
#pragma unroll
      for (int r = 0; r < NG; ++r)
        if (g[r] != 0.f) atomicAdd(o + r, g[r]);
    }
  }
}

extern "C" int splat_rasterize_train_fwd(
    const void* tile_start, const void* tile_end, const void* feats,
    int64_t kp, void* out_c, void* out_lt, void* out_cut, int H, int W,
    int tile_w, int tile_h, int tiles_x, int num_tiles, int chunk,
    float alpha_clamp, float alpha_min, int log_cap, float sat_cut_log,
    int sat_exit, int use_bbox, int ppt, void* stream) {
  const size_t smem = (size_t)TNF * chunk * sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
#define SPLAT_FWD(P)                                                         \
  train_fwd_kernel<P><<<num_tiles, 256, smem, st>>>(                         \
      (const int32_t*)tile_start, (const int32_t*)tile_end,                  \
      (const float*)feats, kp, (float*)out_c, (float*)out_lt,                \
      (int32_t*)out_cut, H, W, tile_w, tile_h, tiles_x, chunk, alpha_clamp,  \
      alpha_min, log_cap, sat_cut_log, sat_exit, use_bbox)
  switch (ppt) {
    case 1: SPLAT_FWD(1); break;
    case 2: SPLAT_FWD(2); break;
    case 4: SPLAT_FWD(4); break;
    case 8: SPLAT_FWD(8); break;
    case 16: SPLAT_FWD(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPLAT_FWD
  return (int)cudaGetLastError();
}

extern "C" int splat_rasterize_train_bwd(
    const void* tile_start, const void* tile_end, const void* cut,
    const void* feats, int64_t kp, const void* ranks, const void* g_c,
    const void* g_lt, const void* lt, void* out, int H, int W, int tile_w,
    int tile_h, int tiles_x, int num_tiles, int chunk, float alpha_clamp,
    float alpha_min, int log_cap, int use_bbox, int ppt, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define SPLAT_BWD(P)                                                         \
  train_bwd_kernel<P><<<num_tiles, 256, 0, st>>>(                            \
      (const int32_t*)tile_start, (const int32_t*)tile_end,                  \
      (const int32_t*)cut, (const float*)feats, kp, (const int64_t*)ranks,   \
      (const float*)g_c, (const float*)g_lt, (const float*)lt, (float*)out,  \
      H, W, tile_w, tile_h, tiles_x, chunk, alpha_clamp, alpha_min, log_cap, \
      use_bbox)
  switch (ppt) {
    case 1: SPLAT_BWD(1); break;
    case 2: SPLAT_BWD(2); break;
    case 4: SPLAT_BWD(4); break;
    case 8: SPLAT_BWD(8); break;
    case 16: SPLAT_BWD(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPLAT_BWD
  return (int)cudaGetLastError();
}
