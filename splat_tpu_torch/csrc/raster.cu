// Per-tile front-to-back compositing (K2).
//
// Replaces the TPU kernel splat_tpu/render/kernels.py::_raster_kernel.
// Blocks of 256 threads; a tile's pixels live in registers (PPT a thread, 4
// for 32x32 tiles; a tile of more than 16 x 256 pixels takes several blocks
// of 16, one per pixel group, as a thread-block cluster that votes like a
// split heavy tile).  The tile's sorted pairs [start, end) are staged through
// shared memory in batches of `chunk` (a batch of more than STAGE_PAIRS in
// parts), and every pixel composites the pairs it keeps serially:
// C += alpha * T * color, T *= 1 - alpha, which is what the TPU's
// exclusive-prefix-product windows compute.  After each batch a vote of the
// whole tile ends the walk once every one of its pixels, pixels past the
// image edge included, has T < alpha_min: the TPU kernel's whole-tile exit at
// batch granularity.  Batches start at absolute multiples of `chunk` in the
// sorted pair array, as the TPU windows do.
//
// Pixel convention as on the TPU: integer pixel coordinates (no +0.5) and
// dy = cy - py.  The image is written as (H, W, C) directly.
//
// What bounds it on the card, and what the design does about it (the
// training kernels, csrc/raster_train.cu, share all three answers through
// csrc/raster_common.cuh):
//
// * The longest tile walk.  A pixel's recurrence over the pairs is serial;
//   at 1M surface gaussians @1080p one tile holds 43,502 pairs, and with
//   one block per tile in raster order that block ran on while the other
//   SMs idled.  Tiles that hold more than SPLIT_MIN_PAIRS pairs and more
//   than the frame's mean load of a resident block (decided on the device,
//   by raster_common.cuh's raster_plan_kernel, in the same stream just
//   before the compositing) are split by pixels across split_of(PPT)
//   blocks, each with PPT / split pixels a thread.  The blocks of one tile
//   form a thread-block cluster and OR their votes through distributed
//   shared memory, so the exit batch and every pixel are those of one
//   block.  A cluster barrier after every batch kept the four blocks in
//   step and cost 30% of the kernel on that frame (H100); instead each block
//   publishes its vote (a strong store at cluster scope) and walks on,
//   and only a block whose own pixels are all saturated waits to read
//   (strong loads) what the others voted on that batch.  A cluster's
//   blocks are resident together, so the wait always ends.
//   Heavy tiles come first in the grid, then the light ones, longest
//   first.
// * Evaluating pairs that cannot reach a pixel.  A warp owns a compact strip
//   of 32 * PPT tile pixels.  Before any expf, its lanes test 32 staged
//   pairs at once, each the pair's box against the strip's pixel nearest to
//   the centre in the same rounded operations as the per-pixel test; a
//   ballot leaves the pairs that some pixel of the strip may keep, and the
//   warp walks only those, in order (only with a finite sigma_cutoff).  A
//   skipped pair is one no pixel of the strip keeps: the image is the same.
// * What is left is arithmetic: per (pixel, pair in the box) one expf and
//   ~14 flops, plus ~9 flops where the pair is kept.  A pair's features sit
//   in shared memory as three float4, read as broadcasts.
//
// Every per-pair float operation is an explicitly rounded intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn, which the compiler never fuses into an
// FMA) in the order of the plain version
// (splat_tpu_torch/render/kernels.py::rasterize_tiles_plain), and expf is
// the full-precision one, so kernel and plain version round alike.

#include <cooperative_groups.h>

#include "raster_common.cuh"

namespace cg = cooperative_groups;

// A block's vote word, written by its owner and read by the other blocks of
// the cluster through distributed shared memory, as strong (relaxed)
// accesses at cluster scope: single-copy atomic and coherent among the
// cluster's threads.  The word is all that crosses between the blocks, no
// other memory is read on the strength of it, so there is nothing for a
// release / acquire pair to order; its fences cost 5% of the kernel at 1M
// surface gaussians @1080p on an H100 (utils/raster_probe.py tune,
// release_acquire_votes).
__device__ __forceinline__ void vote_publish(int* slot, int v) {
  asm volatile("st.relaxed.cluster.b32 [%0], %1;" ::"l"(slot), "r"(v)
               : "memory");
}

__device__ __forceinline__ int vote_read(const int* slot) {
  int v;
  asm volatile("ld.relaxed.cluster.b32 %0, [%1];" : "=r"(v) : "l"(slot)
               : "memory");
  return v;
}

struct RasterArgs {
  const int32_t* tile_start;
  const int32_t* tile_end;
  const float* feats;
  int64_t kp;
  float* out;
  int H, W, tile_w, tile_h, tiles_x, chunk;
  float alpha_clamp, alpha_min, bg0, bg1, bg2;
  int nchan, use_bbox;
};

// K2 for the pixels [group * THREADS * P, (group + 1) * THREADS * P) of
// tile t; with CLUSTER, the tile's blocks form a cluster and vote together.
template <int P, bool CLUSTER>
__device__ __forceinline__ void raster_walk(const RasterArgs& a, int t,
                                            int group, int nsplit,
                                            float4* smem, int* vote) {
  const int s = a.tile_start[t];
  const int e = a.tile_end[t];
  const int npix = a.tile_w * a.tile_h;
  const int x0 = (t % a.tiles_x) * a.tile_w;
  const int y0 = (t / a.tiles_x) * a.tile_h;
  const int base = group * THREADS * P;
  const int lane = threadIdx.x & 31;
  const int pw = base + (threadIdx.x >> 5) * 32 * P + lane;
  const Strip st = warp_strip<P>(base, npix, a.tile_w, x0, y0);

  float px[P], py[P], cr[P], cg_[P], cb[P], tr[P];
  bool on[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = pw + i * 32;
    on[i] = p < npix;
    px[i] = (float)(x0 + p % a.tile_w);
    py[i] = (float)(y0 + p / a.tile_w);
    cr[i] = cg_[i] = cb[i] = 0.f;
    tr[i] = on[i] ? 1.f : 0.f;  // slots past the tile never vote
  }
  if constexpr (CLUSTER) {
    // vote[0] starts at "no batch voted on" before any block reads it
    if (threadIdx.x == 0) vote[0] = 0;
    cg::this_cluster().sync();
  }

  int batch = 0;
  for (int kb = s - s % a.chunk; kb < e; kb += a.chunk, ++batch) {
    // the batch's pairs [max(s, kb), b_end), STAGE_PAIRS at a time
    const int b_end = min(e, kb + a.chunk);
    // not unrolled: unrolling these two loops took K2<4> from 64 to 80
    // registers and K3<4> from 80 to 127 (ptxas, sm_90a)
#pragma unroll 1
    for (int k0 = max(s, kb); k0 < b_end; k0 += STAGE_PAIRS) {
      __syncthreads();  // the previous pairs are consumed
      const int hi = min(b_end - k0, STAGE_PAIRS);
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
              const Alpha al =
                  pair_alpha(px[i], py[i], g0, g1, a.alpha_clamp,
                             a.alpha_min, a.use_bbox);
              if (!al.keep) continue;
              const float w = __fmul_rn(al.alpha, tr[i]);
              cr[i] = __fadd_rn(cr[i], __fmul_rn(w, g2.x));
              cg_[i] = __fadd_rn(cg_[i], __fmul_rn(w, g2.y));
              cb[i] = __fadd_rn(cb[i], __fmul_rn(w, g2.z));
              tr[i] = __fmul_rn(tr[i], __fsub_rn(1.f, al.alpha));
            }
          }
        }
      }
    }
    float tmax = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) tmax = fmaxf(tmax, tr[i]);
    int go = __syncthreads_or(tmax >= a.alpha_min);
    if constexpr (CLUSTER) {
      // The tile goes on if any of its blocks votes to.  A block that does
      // publishes its vote and walks on without waiting; only a block
      // whose own pixels are saturated has to learn what the others voted
      // on this batch.  vote[0] holds 2 * (batch + 1) + vote; a block found
      // past this batch shows that the tile went on.
      const int own = go;
      if (threadIdx.x == 0) {
        vote_publish(&vote[0], 2 * (batch + 1) + own);
        if (!own) {
          cg::cluster_group cl = cg::this_cluster();
          const int me = (int)cl.block_rank();
          bool waiting = true;
          while (waiting && !go) {
            waiting = false;
            for (int r = 0; r < nsplit && !go; ++r) {
              if (r == me) continue;
              const int v = vote_read(cl.map_shared_rank(vote, r));
              if ((v >> 1) > batch + 1 || ((v >> 1) == batch + 1 && (v & 1)))
                go = 1;
              else if ((v >> 1) <= batch)
                waiting = true;  // that block has not voted on this batch
            }
          }
          vote[1] = go;
        }
      }
      if (!own) {  // uniform over the block
        __syncthreads();
        go = vote[1];
      }
    }
    if (!go) break;
  }
  // no block leaves while another may still read its votes
  if constexpr (CLUSTER) cg::this_cluster().sync();

#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = pw + i * 32;
    const int x = x0 + p % a.tile_w;
    const int y = y0 + p / a.tile_w;
    if (!on[i] || x >= a.W || y >= a.H) continue;
    float* o = a.out + ((int64_t)y * a.W + x) * a.nchan;
    o[0] = fminf(fmaxf(__fadd_rn(cr[i], __fmul_rn(tr[i], a.bg0)), 0.f), 1.f);
    o[1] = fminf(fmaxf(__fadd_rn(cg_[i], __fmul_rn(tr[i], a.bg1)), 0.f), 1.f);
    o[2] = fminf(fmaxf(__fadd_rn(cb[i], __fmul_rn(tr[i], a.bg2)), 0.f), 1.f);
    if (a.nchan == 4) o[3] = fminf(fmaxf(__fsub_rn(1.f, tr[i]), 0.f), 1.f);
  }
}

template <int PPT>
__global__ void __launch_bounds__(THREADS) raster_kernel(
    RasterArgs a, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nheavy, int num_tiles, int groups) {
  extern __shared__ float4 smem[];  // [min(chunk, STAGE_PAIRS)][3]
  __shared__ int vote[2];
  if constexpr (PPT == MAX_PPT) {
    if (groups > 1) {  // every tile a cluster of `groups` blocks, in order
      raster_walk<PPT, true>(a, order[blockIdx.x / groups],
                             blockIdx.x % groups, groups, smem, vote);
      return;
    }
  }
  constexpr int S = split_of(PPT);
  Work w;
  if (!work_of(order, nheavy, num_tiles, S, &w)) return;
  if constexpr (S > 1) {
    if (w.split > 1) {  // uniform over the cluster
      raster_walk<PPT / S, true>(a, w.tile, w.group, S, smem, vote);
      return;
    }
  }
  raster_walk<PPT, false>(a, w.tile, 0, 1, smem, vote);
}

template <int PPT>
static cudaError_t launch(const RasterArgs& a, const int32_t* order,
                          const int32_t* nheavy, int num_tiles, int groups,
                          cudaStream_t st) {
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, raster_kernel<PPT>, a,
                                             order, nheavy, num_tiles,
                                             groups);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Builds the work list into order[num_tiles] and nheavy[1], then composites.
extern "C" int splat_rasterize(const void* tile_start, const void* tile_end,
                               void* order, void* nheavy, const void* feats,
                               int64_t kp, void* out, int H, int W,
                               int tile_w, int tile_h, int tiles_x,
                               int num_tiles, int chunk, float alpha_clamp,
                               float alpha_min, float bg0, float bg1,
                               float bg2, int nchan, int use_bbox, int ppt,
                               int groups, int slots, int min_pairs,
                               void* stream) {
  const RasterArgs a = {(const int32_t*)tile_start, (const int32_t*)tile_end,
                        (const float*)feats, kp, (float*)out, H, W, tile_w,
                        tile_h, tiles_x, chunk, alpha_clamp, alpha_min, bg0,
                        bg1, bg2, nchan, use_bbox};
  int32_t* o = (int32_t*)order;
  int32_t* nh = (int32_t*)nheavy;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!valid_launch(ppt, groups)) return (int)cudaErrorInvalidValue;
  // the exit ends a walk early, and where is not known before the launch:
  // the plan goes by the tile's pairs, an upper bound of its walk
  const cudaError_t err = plan_tiles(a.tile_start, a.tile_end, num_tiles,
                                     plan_split(ppt, groups), slots,
                                     min_pairs, o, nh, st);
  if (err != cudaSuccess) return (int)err;
  switch (ppt) {
    case 1: return (int)launch<1>(a, o, nh, num_tiles, groups, st);
    case 2: return (int)launch<2>(a, o, nh, num_tiles, groups, st);
    case 4: return (int)launch<4>(a, o, nh, num_tiles, groups, st);
    case 8: return (int)launch<8>(a, o, nh, num_tiles, groups, st);
    case 16: return (int)launch<16>(a, o, nh, num_tiles, groups, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// strip_reaches() on arrays, one (strip, pair) a thread: strips holds the
// rows xa, xb, ya, yb and boxes the rows cx, cy, rx^2, ry^2, each (4, n).
// Lets a test hold the device function against its Python model
// (render/emulate.py); no render path calls it.
__global__ void strip_reaches_kernel(const float* __restrict__ strips,
                                     const float* __restrict__ boxes,
                                     int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Strip st = {strips[i], strips[n + i], strips[2 * n + i],
                    strips[3 * n + i], true};
  out[i] = strip_reaches(st, make_float4(boxes[i], boxes[n + i],
                                         boxes[2 * n + i], boxes[3 * n + i]));
}

extern "C" int splat_strip_reaches(const void* strips, const void* boxes,
                                   void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  strip_reaches_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const float*)strips, (const float*)boxes, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
