// The training forward (K3) and backward (K4) of the tiled renderer.
//
// K3 replaces the TPU kernel splat_tpu/render/diff.py::_fwd_kernel.  It is
// K2's walk (csrc/raster.cu) without the 1/255 exit: blocks of 256 threads,
// the pixels in registers (PPT per thread; a tile of more than 16 x 256
// pixels takes one block of 16 per pixel group, K3's as a voting cluster),
// the pairs of each window staged through shared memory (a window of more
// than STAGE_PAIRS in parts).  Per pixel and kept pair it carries
// C += alpha * T * color, T *= 1 - alpha' and logT += log1p(-alpha'),
// alpha' = min(alpha, 0.999999) when alpha_clamp >= 0.999999.  Windows are
// `chunk` pairs wide and start at (tile_start / 128) * 128, as the TPU's do.
// After every 4th window, and after each window of the tail, a vote asks
// whether every pixel of the tile, past the image edge included, is
// saturated: logT < sat_cut_log and T == 0 (the exact cut: later pairs add
// exact zeros to the image and to every gradient), or T < alpha_min with
// train_sat_exit.  It writes raw C (H, W, 3), logT (H, W) and the number of
// windows walked per tile.
//
// K4 replaces the TPU kernel splat_tpu/render/diff.py::_bwd_kernel.  It
// walks the pairs of windows [0, cut) in reverse, in batches of BWD_BATCH
// staged through shared memory.  Each pixel carries lt (from logT) and D
// (from dL/dlogT) and recomputes alpha exactly as K3 did; for a kept pair:
// lt_i = lt - log1p(-alpha'), T_i = exp(min(lt_i, 0)),
// gc = sum_c dL/dC_c * color_c, dalpha = T_i * gc - D / (1 - alpha'),
// D += gc * alpha * T_i, lt = lt_i.  Nine sums over the tile's pixels per
// pair (five geometry moments of dpower, three colour sums, the opacity sum)
// are added with atomicAdd into the pair's gaussian row of an (N, 9)
// buffer.  That replaces the TPU's window-padded per-pair buffer, its
// gaussian-id row and the sort-and-segment-sum that followed it.  Pixels
// past the image edge have zero cotangents and are skipped.
//
// What bounds them on the card, and what the design does about it:
//
// * The longest tile walk.  Each pixel's recurrence over the pairs is
//   serial, and at 1M surface gaussians @1080p one tile walks 43,502 pairs:
//   with one block per tile, that block was the whole kernel's time while
//   the other SMs idled.  Tiles that walk more than SPLIT_MIN_PAIRS pairs
//   and more than the frame's mean load of a resident block (decided on
//   the device by raster_common.cuh's raster_plan_kernel, just before each
//   launch) are split by pixels across
//   split_of(PPT) blocks, each with PPT / split pixels per thread; heavy
//   tiles come first in the grid, then the light ones, longest first.  K4
//   has no vote: each block walks its own pixels and adds its own pair sums.
//   K3's blocks of one tile form a thread-block cluster: they walk the same
//   windows in step and AND their votes through distributed shared memory,
//   so the cut and every pixel's C and logT are those of one block.
// * Evaluating pairs that cannot reach a pixel.  A warp owns a compact
//   strip of 32 * PPT tile pixels.  Before any expf, its lanes test 32
//   pairs at once, each the pair's box against the strip's pixel nearest to
//   the centre in the same rounded operations as the per-pixel test; a
//   ballot leaves the pairs that some pixel of the strip may keep, and the
//   warp walks only those, in order (only with a finite sigma_cutoff).
// * K4's per-pair reduction over the warp's lanes.  Shuffles run at a
//   quarter of the FP32 rate; the nine sums halve across the lanes
//   (reduce-scatter): 12 shuffles a kept pair instead of 45.  The 8 warps'
//   sums meet in shared memory once per batch.
// * What is left is arithmetic: per (pixel, pair in the box) one expf and
//   ~14 flops, plus a log1pf and ~10 flops (K3) or an expf, a log1pf, a
//   division and ~33 flops (K4) where the pair is kept.  A pair's features
//   sit in shared memory as three float4, read as broadcasts.
//
// Every per-pair float operation is an explicitly rounded intrinsic, in the
// order of the plain versions (splat_tpu_torch/render/diff.py), with the
// full-precision expf / log1pf, so kernel and plain version round alike;
// K4's pixel sums and atomics add in another order.

#include <cooperative_groups.h>

#include "raster_common.cuh"

namespace cg = cooperative_groups;

#define WINDOW_ALIGN 128  // windows start at (tile_start / 128) * 128
#define SAT_CHECK_EVERY 4
#define ALPHA_LOG_CAP 0.999999f
#define NWARPS 8
#define BWD_BATCH 64
#define NG 9              // dcx, dcy, da2, db2, dc2, dr, dg, db, dop

struct FwdArgs {
  const int32_t* tile_start;
  const int32_t* tile_end;
  const float* feats;
  int64_t kp;
  float* out_c;
  float* out_lt;
  int32_t* out_cut;
  int H, W, tile_w, tile_h, tiles_x, chunk;
  float alpha_clamp, alpha_min;
  int log_cap;
  float sat_cut_log;
  int sat_exit, use_bbox;
};

// K3 for the pixels [group * THREADS * P, (group + 1) * THREADS * P) of
// tile t; with CLUSTER, the tile's blocks form a cluster and vote together.
template <int P, bool CLUSTER>
__device__ __forceinline__ void fwd_walk(const FwdArgs& a, int t, int group,
                                         int nsplit, float4* smem,
                                         int* vote) {
  const int s = a.tile_start[t];
  const int e = a.tile_end[t];
  const int npix = a.tile_w * a.tile_h;
  const int x0 = (t % a.tiles_x) * a.tile_w;
  const int y0 = (t / a.tiles_x) * a.tile_h;
  const int base = group * THREADS * P;
  const int lane = threadIdx.x & 31;
  const int pw = base + (threadIdx.x >> 5) * 32 * P + lane;
  const Strip st = warp_strip<P>(base, npix, a.tile_w, x0, y0);

  float px[P], py[P], cr[P], cg_[P], cb[P], tr[P], lt[P];
  bool on[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = pw + i * 32;
    on[i] = p < npix;
    px[i] = (float)(x0 + p % a.tile_w);
    py[i] = (float)(y0 + p / a.tile_w);
    cr[i] = cg_[i] = cb[i] = lt[i] = 0.f;
    tr[i] = 1.f;
  }

  const int wbase = s - s % WINDOW_ALIGN;
  const int nch = (e - wbase + a.chunk - 1) / a.chunk;
  const int n_full = nch / SAT_CHECK_EVERY * SAT_CHECK_EVERY;
  int walked = 0, checks = 0;
  for (int j = 0; j < nch; ++j) {
    // the window's pairs [max(s, kb), w_end), STAGE_PAIRS at a time
    const int kb = wbase + j * a.chunk;
    const int w_end = min(e, kb + a.chunk);
    // not unrolled: unrolling these two loops took K2<4> from 64 to 80
    // registers and K3<4> from 80 to 127 (ptxas, sm_90a)
#pragma unroll 1
    for (int k0 = max(s, kb); k0 < w_end; k0 += STAGE_PAIRS) {
      __syncthreads();  // the previous pairs are consumed
      const int hi = min(w_end - k0, STAGE_PAIRS);
#pragma unroll 1
      for (int q = threadIdx.x; q < hi; q += THREADS)
        stage_pair(smem + 3 * q, a.feats, a.kp, k0 + q);
      __syncthreads();
      if (st.any) {
        // lane l tests pair q0 + l against the warp's strip; the warp then
        // walks the pairs that passed, in order
        for (int q0 = 0; q0 < hi; q0 += 32) {
          const int ql = q0 + lane;
          unsigned hits = __ballot_sync(
              FULL,
              ql < hi && (!a.use_bbox || strip_reaches(st, smem[3 * ql])));
          while (hits) {
            const int q = q0 + __ffs(hits) - 1;
            hits &= hits - 1;
            const float4 g0 = smem[3 * q];
            const float4 g1 = smem[3 * q + 1];
            const float4 g2 = smem[3 * q + 2];
#pragma unroll
            for (int i = 0; i < P; ++i) {
              if (!on[i]) continue;
              const Alpha al_ = pair_alpha(px[i], py[i], g0, g1,
                                           a.alpha_clamp, a.alpha_min,
                                           a.use_bbox);
              if (!al_.keep) continue;
              const float al =
                  a.log_cap ? fminf(al_.alpha, ALPHA_LOG_CAP) : al_.alpha;
              const float w = __fmul_rn(al_.alpha, tr[i]);
              cr[i] = __fadd_rn(cr[i], __fmul_rn(w, g2.x));
              cg_[i] = __fadd_rn(cg_[i], __fmul_rn(w, g2.y));
              cb[i] = __fadd_rn(cb[i], __fmul_rn(w, g2.z));
              tr[i] = __fmul_rn(tr[i], __fsub_rn(1.f, al));
              lt[i] = __fadd_rn(lt[i], log1pf(-al));
            }
          }
        }
      }
    }
    walked = j + 1;
    if ((walked % SAT_CHECK_EVERY == 0 && walked <= n_full) ||
        walked > n_full) {
      bool sat = true;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (!on[i]) continue;
        sat = sat && (a.sat_exit ? tr[i] < a.alpha_min
                                 : (lt[i] < a.sat_cut_log && tr[i] == 0.f));
      }
      int all = __syncthreads_and(sat);
      if constexpr (CLUSTER) {
        // two slots: a block rewrites one only after the next cluster
        // barrier, which every block passes after reading it
        cg::cluster_group cl = cg::this_cluster();
        int* slot = vote + (checks & 1);
        if (threadIdx.x == 0) *slot = all;
        cl.sync();
        for (int r = 0; r < nsplit; ++r)
          all = all && *cl.map_shared_rank(slot, r);
        ++checks;
      }
      if (all) break;
    }
  }
  // no block leaves while another may still read its votes
  if constexpr (CLUSTER) cg::this_cluster().sync();

  if (group == 0 && threadIdx.x == 0) a.out_cut[t] = walked;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = pw + i * 32;
    const int x = x0 + p % a.tile_w;
    const int y = y0 + p / a.tile_w;
    if (!on[i] || x >= a.W || y >= a.H) continue;
    const int64_t o = (int64_t)y * a.W + x;
    a.out_c[o * 3 + 0] = cr[i];
    a.out_c[o * 3 + 1] = cg_[i];
    a.out_c[o * 3 + 2] = cb[i];
    a.out_lt[o] = lt[i];
  }
}

template <int PPT>
__global__ void __launch_bounds__(THREADS) train_fwd_kernel(
    FwdArgs a, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nheavy, int num_tiles, int groups) {
  extern __shared__ float4 smem[];  // [min(chunk, STAGE_PAIRS)][3]
  __shared__ int vote[2];
  if constexpr (PPT == MAX_PPT) {
    if (groups > 1) {  // every tile a cluster of `groups` blocks, in order
      fwd_walk<PPT, true>(a, order[blockIdx.x / groups], blockIdx.x % groups,
                          groups, smem, vote);
      return;
    }
  }
  constexpr int S = split_of(PPT);
  Work w;
  if (!work_of(order, nheavy, num_tiles, S, &w)) return;
  if constexpr (S > 1) {
    if (w.split > 1) {  // uniform over the cluster
      fwd_walk<PPT / S, true>(a, w.tile, w.group, S, smem, vote);
      return;
    }
  }
  fwd_walk<PPT, false>(a, w.tile, 0, 1, smem, vote);
}

// Sums v[field] over the warp's 32 lanes and stores the 9 sums in row q
// of sred.  Halving: at offsets 16, 8, 4 and 2 the lanes exchange half of
// the fields they hold (9 -> 5 -> 3 -> 2 -> 1, the odd one out padded
// with 0), then add at offset 1: 12 shuffles a pair instead of 45.
__device__ __forceinline__ void warp_reduce_store(const float (&v)[NG],
                                                  float* sred_q) {
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float h5[5];  // fields (b4 ? 5 : 0) + i
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float lo = v[i], hi = i < 4 ? v[5 + i] : 0.f;
    h5[i] = (b4 ? hi : lo) + __shfl_xor_sync(FULL, b4 ? lo : hi, 16);
  }
  float h3[3];  // h5[(b3 ? 3 : 0) + i]
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float lo = h5[i], hi = i < 2 ? h5[3 + i] : 0.f;
    h3[i] = (b3 ? hi : lo) + __shfl_xor_sync(FULL, b3 ? lo : hi, 8);
  }
  float h2[2];  // h3[(b2 ? 2 : 0) + i]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lo = h3[i], hi = i < 1 ? h3[2 + i] : 0.f;
    h2[i] = (b2 ? hi : lo) + __shfl_xor_sync(FULL, b2 ? lo : hi, 4);
  }
  float h1 = (b1 ? h2[1] : h2[0]) +  // h2[b1 ? 1 : 0]
             __shfl_xor_sync(FULL, b1 ? h2[0] : h2[1], 2);
  h1 += __shfl_xor_sync(FULL, h1, 1);
  const int i3 = (b2 ? 2 : 0) + (b1 ? 1 : 0);
  const int i5 = (b3 ? 3 : 0) + i3;
  if (!(lane & 1) && i3 < (b3 ? 2 : 3) && i5 < (b4 ? 4 : 5))
    sred_q[(b4 ? 5 : 0) + i5] = h1;
}

struct BwdArgs {
  const int32_t* tile_start;
  const int32_t* tile_end;
  const int32_t* cut;
  const float* feats;
  int64_t kp;
  const int64_t* ranks;
  const float* g_c;
  const float* g_lt;
  const float* lt_img;
  float* out;
  int H, W, tile_w, tile_h, tiles_x, chunk;
  float alpha_clamp, alpha_min;
  int log_cap, use_bbox;
};

// K4 for the pixels [group * THREADS * P, (group + 1) * THREADS * P) of
// tile t.
template <int P>
__device__ __forceinline__ void bwd_walk(const BwdArgs& a, int t, int group,
                                         float4* sf,
                                         float (*sred)[BWD_BATCH][NG]) {
  const int s = a.tile_start[t];
  const int e = a.tile_end[t];
  const int wbase = s - s % WINDOW_ALIGN;
  const int nch = (e - wbase + a.chunk - 1) / a.chunk;
  const int c = a.cut[t] < nch ? a.cut[t] : nch;
  const int walk_end = min(e, wbase + c * a.chunk);
  if (walk_end <= s) return;  // uniform over the block
  const int npix = a.tile_w * a.tile_h;
  const int x0 = (t % a.tiles_x) * a.tile_w;
  const int y0 = (t / a.tiles_x) * a.tile_h;
  const int base = group * THREADS * P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pw = base + warp * 32 * P + lane;
  const Strip st = warp_strip<P>(base, npix, a.tile_w, x0, y0);

  float px[P], py[P], gr[P], gg[P], gb[P], dd[P], ll[P];
  bool on[P];
  bool mine = false;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = pw + i * 32;
    const int x = x0 + p % a.tile_w;
    const int y = y0 + p / a.tile_w;
    on[i] = p < npix && x < a.W && y < a.H;
    mine = mine || on[i];
    px[i] = (float)x;
    py[i] = (float)y;
    const int64_t o = on[i] ? (int64_t)y * a.W + x : 0;
    gr[i] = on[i] ? a.g_c[o * 3 + 0] : 0.f;
    gg[i] = on[i] ? a.g_c[o * 3 + 1] : 0.f;
    gb[i] = on[i] ? a.g_c[o * 3 + 2] : 0.f;
    dd[i] = on[i] ? a.g_lt[o] : 0.f;
    ll[i] = on[i] ? a.lt_img[o] : 0.f;
  }
  const bool warp_on = st.any && __any_sync(FULL, mine);
  float* sred_flat = &sred[0][0][0];

  for (int hi = walk_end; hi > s; hi -= BWD_BATCH) {
    const int lo = hi - BWD_BATCH > s ? hi - BWD_BATCH : s;
    const int nb = hi - lo;
    __syncthreads();  // the previous batch's sums are consumed
    for (int q = threadIdx.x; q < nb; q += THREADS)
      stage_pair(sf + 3 * q, a.feats, a.kp, lo + q);
    for (int q = threadIdx.x; q < NWARPS * BWD_BATCH * NG; q += THREADS)
      sred_flat[q] = 0.f;
    __syncthreads();
    // lane l tests pair q0 - l against the warp's strip; the warp then
    // walks the pairs that passed, in reverse
    for (int q0 = warp_on ? nb - 1 : -1; q0 >= 0; q0 -= 32) {
      const int ql = q0 - lane;
      unsigned hits = __ballot_sync(
          FULL, ql >= 0 && (!a.use_bbox || strip_reaches(st, sf[3 * ql])));
      while (hits) {
        const int q = q0 - (__ffs(hits) - 1);
        hits &= hits - 1;
        const float4 g0 = sf[3 * q];
        const float4 g1 = sf[3 * q + 1];
        const float4 g2 = sf[3 * q + 2];
        float acc[NG];
#pragma unroll
        for (int r = 0; r < NG; ++r) acc[r] = 0.f;
        bool any = false;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (!on[i]) continue;
          const Alpha al_ = pair_alpha(px[i], py[i], g0, g1, a.alpha_clamp,
                                       a.alpha_min, a.use_bbox);
          if (!al_.keep) continue;
          any = true;
          const float al =
              a.log_cap ? fminf(al_.alpha, ALPHA_LOG_CAP) : al_.alpha;
          const float l_i = __fsub_rn(ll[i], log1pf(-al));
          const float t_i = expf(fminf(l_i, 0.f));
          const float gcw = __fadd_rn(
              __fadd_rn(__fmul_rn(gr[i], g2.x), __fmul_rn(gg[i], g2.y)),
              __fmul_rn(gb[i], g2.z));
          const float wgt = __fmul_rn(al_.alpha, t_i);
          const float da = __fsub_rn(__fmul_rn(t_i, gcw),
                                     __fdiv_rn(dd[i], __fsub_rn(1.f, al)));
          if (al_.a_raw < a.alpha_clamp) {
            const float dp = __fmul_rn(da, al_.alpha);
            acc[0] = __fadd_rn(acc[0], __fmul_rn(dp, al_.dx));
            acc[1] = __fadd_rn(acc[1], __fmul_rn(dp, al_.dy));
            acc[2] = __fadd_rn(acc[2], __fmul_rn(dp, al_.dx2));
            acc[3] = __fadd_rn(acc[3],
                               __fmul_rn(dp, __fmul_rn(al_.dx, al_.dy)));
            acc[4] = __fadd_rn(acc[4], __fmul_rn(dp, al_.dy2));
            acc[8] = __fadd_rn(acc[8], __fmul_rn(da, al_.expp));
          }
          acc[5] = __fadd_rn(acc[5], __fmul_rn(gr[i], wgt));
          acc[6] = __fadd_rn(acc[6], __fmul_rn(gg[i], wgt));
          acc[7] = __fadd_rn(acc[7], __fmul_rn(gb[i], wgt));
          dd[i] = __fadd_rn(dd[i], __fmul_rn(gcw, wgt));
          ll[i] = l_i;
        }
        // pairs no lane kept leave the warp's row of zeros
        if (__any_sync(FULL, any)) warp_reduce_store(acc, sred[warp][q]);
      }
    }
    __syncthreads();
    for (int q2 = threadIdx.x; q2 < nb; q2 += THREADS) {
      float v[NG];
      bool nz = false;
#pragma unroll
      for (int r = 0; r < NG; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) sum += sred[w][q2][r];
        v[r] = sum;
        nz = nz || sum != 0.f;
      }
      if (!nz) continue;
      // power = a2 dx^2 + c2 dy^2 + b2 dx dy, dx = px - cx, dy = cy - py
      const float4 g1 = sf[3 * q2 + 1];
      const float a2 = g1.x, b2 = g1.y, c2 = g1.z;
      const float g[NG] = {-(2.f * a2 * v[0] + b2 * v[1]),
                           2.f * c2 * v[1] + b2 * v[0],
                           v[2], v[3], v[4], v[5], v[6], v[7], v[8]};
      float* o = a.out + a.ranks[lo + q2] * NG;
#pragma unroll
      for (int r = 0; r < NG; ++r)
        if (g[r] != 0.f) atomicAdd(o + r, g[r]);
    }
  }
}

// Three blocks an SM where PPT <= 4: 80 registers (a few bytes spill),
// which K4's latency-bound walk prefers to two blocks at 121.
template <int PPT>
__global__ void __launch_bounds__(THREADS, PPT <= 4 ? 3 : 1)
    train_bwd_kernel(
    BwdArgs a, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nheavy, int num_tiles, int groups) {
  __shared__ float4 sf[BWD_BATCH * 3];
  __shared__ float sred[NWARPS][BWD_BATCH][NG];
  if constexpr (PPT == MAX_PPT) {
    if (groups > 1) {  // every tile `groups` blocks, in order
      bwd_walk<PPT>(a, order[blockIdx.x / groups], blockIdx.x % groups, sf,
                    sred);
      return;
    }
  }
  constexpr int S = split_of(PPT);
  Work w;
  if (!work_of(order, nheavy, num_tiles, S, &w)) return;
  if constexpr (S > 1) {
    if (w.split > 1) {
      bwd_walk<PPT / S>(a, w.tile, w.group, sf, sred);
      return;
    }
  }
  bwd_walk<PPT>(a, w.tile, 0, sf, sred);
}

template <int PPT>
static cudaError_t launch_fwd(const FwdArgs& a, const int32_t* order,
                              const int32_t* nheavy, int num_tiles,
                              int groups, cudaStream_t st) {
  const int S = blocks_per_tile(PPT, groups);
  const int staged = a.chunk < STAGE_PAIRS ? a.chunk : STAGE_PAIRS;
  const size_t smem = (size_t)3 * sizeof(float4) * staged;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)num_tiles * S);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, train_fwd_kernel<PPT>, a,
                                             order, nheavy, num_tiles,
                                             groups);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Builds the work list into order[num_tiles] and nheavy[1] (the walk is not
// known before the cut: the plan goes by the tile's pairs), then runs K3.
extern "C" int splat_rasterize_train_fwd(
    const void* tile_start, const void* tile_end, void* order,
    void* nheavy, const void* feats, int64_t kp, void* out_c,
    void* out_lt, void* out_cut, int H, int W, int tile_w, int tile_h,
    int tiles_x, int num_tiles, int chunk, float alpha_clamp,
    float alpha_min, int log_cap, float sat_cut_log, int sat_exit,
    int use_bbox, int ppt, int groups, int slots, int min_pairs,
    void* stream) {
  const FwdArgs a = {(const int32_t*)tile_start, (const int32_t*)tile_end,
                     (const float*)feats, kp, (float*)out_c, (float*)out_lt,
                     (int32_t*)out_cut, H, W, tile_w, tile_h, tiles_x, chunk,
                     alpha_clamp, alpha_min, log_cap, sat_cut_log, sat_exit,
                     use_bbox};
  int32_t* o = (int32_t*)order;
  int32_t* nh = (int32_t*)nheavy;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!valid_launch(ppt, groups)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = plan_tiles(a.tile_start, a.tile_end, num_tiles,
                                     plan_split(ppt, groups), slots,
                                     min_pairs, o, nh, st);
  if (err != cudaSuccess) return (int)err;
  switch (ppt) {
    case 1: return (int)launch_fwd<1>(a, o, nh, num_tiles, groups, st);
    case 2: return (int)launch_fwd<2>(a, o, nh, num_tiles, groups, st);
    case 4: return (int)launch_fwd<4>(a, o, nh, num_tiles, groups, st);
    case 8: return (int)launch_fwd<8>(a, o, nh, num_tiles, groups, st);
    case 16: return (int)launch_fwd<16>(a, o, nh, num_tiles, groups, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Builds the work list from the walks [tile_start, walk_end) that the
// forward's cut leaves (walk_end[num_tiles], one past each tile's last
// walked pair) into order[num_tiles] and nheavy[1], then runs K4.
extern "C" int splat_rasterize_train_bwd(
    const void* tile_start, const void* tile_end, const void* cut,
    const void* walk_end, void* order, void* nheavy, const void* feats,
    int64_t kp,
    const void* ranks, const void* g_c, const void* g_lt, const void* lt,
    void* out, int H, int W, int tile_w, int tile_h, int tiles_x,
    int num_tiles, int chunk, float alpha_clamp, float alpha_min,
    int log_cap, int use_bbox, int ppt, int groups, int slots,
    int min_pairs, void* stream) {
  const BwdArgs a = {(const int32_t*)tile_start, (const int32_t*)tile_end,
                     (const int32_t*)cut, (const float*)feats, kp,
                     (const int64_t*)ranks, (const float*)g_c,
                     (const float*)g_lt, (const float*)lt, (float*)out, H, W,
                     tile_w, tile_h, tiles_x, chunk, alpha_clamp, alpha_min,
                     log_cap, use_bbox};
  int32_t* o = (int32_t*)order;
  int32_t* nh = (int32_t*)nheavy;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!valid_launch(ppt, groups)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = plan_tiles(a.tile_start, (const int32_t*)walk_end,
                                     num_tiles, plan_split(ppt, groups),
                                     slots, min_pairs, o, nh, st);
  if (err != cudaSuccess) return (int)err;
#define SPLAT_BWD(P)                                                        \
  train_bwd_kernel<P><<<num_tiles * blocks_per_tile(P, groups), THREADS, 0, \
                        st>>>(a, o, nh, num_tiles, groups)
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
