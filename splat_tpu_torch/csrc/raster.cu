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
// subtile_exit (the TPU kernel's per-pixel-group exit, which it runs as phase
// compaction): a heavy tile, one whose pair range holds more than
// heavy_pairs pairs, whose pixels divide into 8 x 16 groups, is laid out
// group by group instead of row by row (raster_walk<P, _, true>).  At 4 or
// more pixels a thread a warp then holds P / 4 whole groups, a lane 4 pixels
// of each; at fewer, a group spans 4 / P warps.  After each batch every
// group whose pixels all have T < alpha_min / 2^GROUP_STOP_SHIFT stops: a
// warp's lanes OR their groups' flags (__reduce_or_sync), and where a group
// spans warps they meet in a shared word.  So what a stopped pixel leaves
// out is below 2^-GROUP_STOP_SHIFT of alpha_min, and the image is within
// that of the whole-tile exit's.  A warp walks only the pairs of its live
// groups' pixels and none at all once its groups have stopped; a block
// whose groups have all stopped stages no more pairs.  Where the tile ends
// is the whole-tile rule's, voted across the cluster as on any split tile.
// Light tiles, and every tile without subtile_exit, take the kernel as it
// was (raster_kernel<PPT, false> is launched when subtile_exit is off).
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
  // subtile_exit: groups in a row of the tile (0: no tile is grouped), and
  // the pair count above which a tile is heavy
  int group_cols, heavy_pairs;
};

// subtile_exit's pixel groups (render/kernels.py::group_grid)
#define GROUP_W 16
#define GROUP_H 8
#define GROUP_PX (GROUP_W * GROUP_H)
// a group stops once all its pixels have T < alpha_min / 2^GROUP_STOP_SHIFT
#define GROUP_STOP_SHIFT 12

__device__ __forceinline__ bool grouped_tile(const RasterArgs& a, int t) {
  return a.group_cols > 0 && a.tile_end[t] - a.tile_start[t] > a.heavy_pairs;
}

// Pixel slot p of a tile -> its (x, y) in the tile: row by row, or group
// by group (GROUPED: slot g * GROUP_PX + q is pixel q of group g, groups
// row by row, group_cols to a row).
template <bool GROUPED>
__device__ __forceinline__ void slot_xy(const RasterArgs& a, int p, int* x,
                                        int* y) {
  if constexpr (GROUPED) {
    const int g = p / GROUP_PX, q = p % GROUP_PX;
    *x = (g % a.group_cols) * GROUP_W + q % GROUP_W;
    *y = (g / a.group_cols) * GROUP_H + q / GROUP_W;
  } else {
    *x = p % a.tile_w;
    *y = p / a.tile_w;
  }
}

// The rectangle that holds a warp's slots in the group-by-group layout (a
// superset where they span several groups): the strip test may only pass
// more pairs than the pixels keep, never fewer.
template <int P>
__device__ __forceinline__ Strip group_strip(const RasterArgs& a, int base,
                                             int npix, int x0, int y0) {
  Strip st;
  const int pa = base + (threadIdx.x >> 5) * 32 * P;
  const int pb = min(pa + 32 * P, npix) - 1;
  st.any = pa < npix;
  const int ga = pa / GROUP_PX, gb = pb / GROUP_PX;
  const int gxa = ga % a.group_cols, gya = ga / a.group_cols;
  if (ga == gb) {
    const int ra = (pa % GROUP_PX) / GROUP_W, rb = (pb % GROUP_PX) / GROUP_W;
    st.xa = (float)(x0 + gxa * GROUP_W + (ra == rb ? pa % GROUP_W : 0));
    st.xb = (float)(x0 + gxa * GROUP_W +
                    (ra == rb ? pb % GROUP_W : GROUP_W - 1));
    st.ya = (float)(y0 + gya * GROUP_H + ra);
    st.yb = (float)(y0 + gya * GROUP_H + rb);
  } else if (gya == gb / a.group_cols) {
    st.xa = (float)(x0 + gxa * GROUP_W);
    st.xb = (float)(x0 + (gb % a.group_cols) * GROUP_W + GROUP_W - 1);
    st.ya = (float)(y0 + gya * GROUP_H);
    st.yb = (float)(y0 + gya * GROUP_H + GROUP_H - 1);
  } else {
    st.xa = (float)x0;
    st.xb = (float)(x0 + a.tile_w - 1);
    st.ya = (float)(y0 + gya * GROUP_H);
    st.yb = (float)(y0 + (gb / a.group_cols) * GROUP_H + GROUP_H - 1);
  }
  return st;
}

// A grouped walk's flag bit of a lane's pixel i: at P >= 4 the lane's
// pixels 4u .. 4u + 3 are in the warp's u-th group; below, all in one.
template <int P>
__host__ __device__ constexpr int unit_of(int i) {
  return P >= 4 ? i / 4 : 0;
}

// K2 for the pixel slots [group * THREADS * P, (group + 1) * THREADS * P)
// of tile t.  With CLUSTER, the tile's blocks form a cluster and vote
// together on where the tile ends.  GROUPED: the slots are laid out group
// by group, and each pixel group also stops on its own.
template <int P, bool CLUSTER, bool GROUPED>
__device__ __forceinline__ void raster_walk(const RasterArgs& a, int t,
                                            int group, int nsplit,
                                            float4* smem, int* vote,
                                            unsigned* gvote) {
  constexpr bool VOTES = CLUSTER;
  const int s = a.tile_start[t];
  const int e = a.tile_end[t];
  const int npix = a.tile_w * a.tile_h;
  const int x0 = (t % a.tiles_x) * a.tile_w;
  const int y0 = (t / a.tiles_x) * a.tile_h;
  const int base = group * THREADS * P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pw = base + warp * 32 * P + lane;
  Strip st;
  if constexpr (GROUPED) {
    st = group_strip<P>(a, base, npix, x0, y0);
  } else {
    st = warp_strip<P>(base, npix, a.tile_w, x0, y0);
  }

  float px[P], py[P], cr[P], cg_[P], cb[P], tr[P];
  bool on[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = pw + i * 32;
    int x, y;
    slot_xy<GROUPED>(a, p, &x, &y);
    on[i] = p < npix;
    px[i] = (float)(x0 + x);
    py[i] = (float)(y0 + y);
    cr[i] = cg_[i] = cb[i] = 0.f;
    tr[i] = on[i] ? 1.f : 0.f;  // slots past the tile never vote
  }
  // GROUPED: bit u is set while the warp's u-th group (P >= 4), or the
  // group the warp holds a share of, is live; warp-uniform.  busy: some
  // group of the block is live; block-uniform
  unsigned live = P >= 4 ? (1u << (P / 4)) - 1u : 1u;
  int busy = 1;
  const float gstop = a.alpha_min * (1.f / (1 << GROUP_STOP_SHIFT));
  if constexpr (VOTES) {
    // vote[0] starts at "no batch voted on" before any block reads it
    if (threadIdx.x == 0) vote[0] = 0;
    cg::this_cluster().sync();
  }
  if constexpr (GROUPED && P < 4) {
    // cleared before the first staging barrier orders them
    if (threadIdx.x == 0) gvote[0] = gvote[1] = 0u;
  }

  int batch = 0;
  for (int kb = s - s % a.chunk; kb < e; kb += a.chunk, ++batch) {
    // the batch's pairs [max(s, kb), b_end), STAGE_PAIRS at a time
    const int b_end = min(e, kb + a.chunk);
    // not unrolled: unrolling these two loops took K2<4> from 64 to 80
    // registers and K3<4> from 80 to 127 (ptxas, sm_90a)
#pragma unroll 1
    for (int k0 = max(s, kb); busy && k0 < b_end; k0 += STAGE_PAIRS) {
      __syncthreads();  // the previous pairs are consumed
      const int hi = min(b_end - k0, STAGE_PAIRS);
#pragma unroll 1
      for (int q = threadIdx.x; q < hi; q += THREADS)
        stage_pair(smem + 3 * q, a.feats, a.kp, k0 + q);
      __syncthreads();
      if (st.any && live) {
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
              if (GROUPED && !((live >> unit_of<P>(i)) & 1u)) continue;
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
    int go;
    if constexpr (GROUPED) {
      // each group's flag: some pixel of it still has T >= gstop
      unsigned mine = 0u;
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (tr[i] >= gstop) mine |= 1u << unit_of<P>(i);
      mine = __reduce_or_sync(FULL, mine);
      if constexpr (P < 4) {
        // the warps of a group meet in gvote[batch & 1], bit (warp * P /
        // 4); thread 0 clears the other word for the next batch, which
        // no thread reads or writes before the next barrier
        if (lane == 0 && mine)
          atomicOr(&gvote[batch & 1], 1u << (warp * P / 4));
        busy = __syncthreads_or(mine != 0u);
        live = (gvote[batch & 1] >> (warp * P / 4)) & 1u;
        if (threadIdx.x == 0) gvote[(batch + 1) & 1] = 0u;
      } else {
        live = mine;
        busy = __syncthreads_or(mine != 0u);
      }
      // a pixel with T >= alpha_min keeps its group live: no barrier where
      // none is
      go = busy ? __syncthreads_or(tmax >= a.alpha_min) : 0;
    } else {
      go = __syncthreads_or(tmax >= a.alpha_min);
    }
    if constexpr (VOTES) {
      // The tile goes on if any of its blocks votes to.  A block that
      // does publishes its vote and walks on without waiting; only a
      // block whose own pixels are saturated has to learn what the others
      // voted on this batch.  vote[0] holds 2 * (batch + 1) + vote; a
      // block found past this batch shows that the tile went on.
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
              if ((v >> 1) > batch + 1 ||
                  ((v >> 1) == batch + 1 && (v & 1)))
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
  if constexpr (VOTES) cg::this_cluster().sync();

#pragma unroll
  for (int i = 0; i < P; ++i) {
    int x, y;
    slot_xy<GROUPED>(a, pw + i * 32, &x, &y);
    x += x0;
    y += y0;
    if (!on[i] || x >= a.W || y >= a.H) continue;
    float* o = a.out + ((int64_t)y * a.W + x) * a.nchan;
    o[0] = fminf(fmaxf(__fadd_rn(cr[i], __fmul_rn(tr[i], a.bg0)), 0.f), 1.f);
    o[1] = fminf(fmaxf(__fadd_rn(cg_[i], __fmul_rn(tr[i], a.bg1)), 0.f), 1.f);
    o[2] = fminf(fmaxf(__fadd_rn(cb[i], __fmul_rn(tr[i], a.bg2)), 0.f), 1.f);
    if (a.nchan == 4) o[3] = fminf(fmaxf(__fsub_rn(1.f, tr[i]), 0.f), 1.f);
  }
}

// One launch's blocks: each takes its tile (and pixel group) from the work
// list.  SUBTILE: heavy tiles take the grouped walk (grouped_tile); without
// it the kernel holds only the whole-tile walks.
template <int PPT, bool SUBTILE>
__device__ __forceinline__ void raster_tiles(
    const RasterArgs& a, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nheavy, int num_tiles, int groups) {
  extern __shared__ float4 smem[];  // [min(chunk, STAGE_PAIRS)][3]
  __shared__ int vote[2];
  __shared__ unsigned gvote[2];
  if constexpr (PPT == MAX_PPT) {
    if (groups > 1) {  // every tile a cluster of `groups` blocks, in order
      const int t = order[blockIdx.x / groups];
      if constexpr (SUBTILE) {
        if (grouped_tile(a, t)) {
          raster_walk<PPT, true, true>(a, t, blockIdx.x % groups, groups,
                                       smem, vote, gvote);
          return;
        }
      }
      raster_walk<PPT, true, false>(a, t, blockIdx.x % groups, groups, smem,
                                    vote, gvote);
      return;
    }
  }
  constexpr int S = split_of(PPT);
  Work w;
  if (!work_of(order, nheavy, num_tiles, S, &w)) return;
  if constexpr (S > 1) {
    if (w.split > 1) {  // uniform over the cluster
      if constexpr (SUBTILE) {
        if (grouped_tile(a, w.tile)) {
          raster_walk<PPT / S, true, true>(a, w.tile, w.group, S, smem, vote,
                                           gvote);
          return;
        }
      }
      raster_walk<PPT / S, true, false>(a, w.tile, w.group, S, smem, vote,
                                        gvote);
      return;
    }
  }
  if constexpr (SUBTILE) {
    if (grouped_tile(a, w.tile)) {
      raster_walk<PPT, false, true>(a, w.tile, 0, 1, smem, vote, gvote);
      return;
    }
  }
  raster_walk<PPT, false, false>(a, w.tile, 0, 1, smem, vote, gvote);
}

template <int PPT, bool SUBTILE>
__global__ void __launch_bounds__(THREADS) raster_kernel(
    RasterArgs a, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nheavy, int num_tiles, int groups) {
  raster_tiles<PPT, SUBTILE>(a, order, nheavy, num_tiles, groups);
}

// The grouped walk takes K2<4> past 64 registers (to 80 as first
// written): 3 blocks an SM where the whole-tile kernel keeps 4, and light
// tiles 4% slower (0.529 against 0.507 ms at 1M random gaussians @1080p,
// H100).  Held to 4 blocks it spills 84 bytes, runs light tiles as fast
// as the whole-tile kernel and the surface frame's heavy ones 0.8% faster
// (utils/raster_probe.py tune --subtile: variant subtile_blocks_3 is the
// kernel without the bound).
__global__ void __launch_bounds__(THREADS, 4) raster_kernel_subtile4(
    RasterArgs a, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nheavy, int num_tiles, int groups) {
  raster_tiles<4, true>(a, order, nheavy, num_tiles, groups);
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
  cudaError_t err;
  if (a.group_cols == 0) {
    err = cudaLaunchKernelEx(&cfg, raster_kernel<PPT, false>, a, order,
                             nheavy, num_tiles, groups);
  } else if constexpr (PPT == 4) {
    err = cudaLaunchKernelEx(&cfg, raster_kernel_subtile4, a, order, nheavy,
                             num_tiles, groups);
  } else {
    err = cudaLaunchKernelEx(&cfg, raster_kernel<PPT, true>, a, order,
                             nheavy, num_tiles, groups);
  }
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
                               int group_cols, int heavy_pairs,
                               void* stream) {
  const RasterArgs a = {(const int32_t*)tile_start, (const int32_t*)tile_end,
                        (const float*)feats, kp, (float*)out, H, W, tile_w,
                        tile_h, tiles_x, chunk, alpha_clamp, alpha_min, bg0,
                        bg1, bg2, nchan, use_bbox, group_cols, heavy_pairs};
  // group_cols > 0 (subtile_exit) needs a tile of whole 8 x 16 groups
  if (group_cols < 0 || (group_cols > 0 && (group_cols * GROUP_W != tile_w ||
                                            tile_h % GROUP_H != 0)))
    return (int)cudaErrorInvalidValue;
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
