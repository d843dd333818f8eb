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
// training kernels, csrc/raster_train.cu, share the split by pixels, the
// strip test and the arithmetic through csrc/raster_common.cuh; the depth
// segments are K2's alone):
//
// * The longest walks.  A pixel's recurrence over the pairs is serial, so
//   a block's walk lasts as long as its tile's range up to the exit, and
//   the kernel as long as its longest walks while the other SMs idle.
//   Tiles that hold more than SPLIT_MIN_PAIRS pairs and more than the
//   frame's mean load of a resident block (`cap`, decided on the device by
//   raster_common.cuh's raster_plan_kernel, in the same stream just before
//   the compositing) are heavy, and split by pixels across split_of(PPT)
//   blocks, each with PPT / split pixels a thread.  The blocks of one tile
//   form a thread-block cluster and OR their votes through distributed
//   shared memory, so the exit batch and every pixel are those of one
//   block.  A cluster barrier after every batch kept the four blocks in
//   step and cost 30% of the kernel at 1M surface gaussians (H100); instead
//   each block publishes its vote (a strong store at cluster scope) and
//   walks on, and only a block whose own pixels are all saturated waits to
//   read (strong loads) what the others voted on that batch.  A cluster's
//   blocks are resident together, so the wait always ends.
//   That split does not shorten a walk, and a light tile's one block walks
//   each pair several pixels a thread, the slower: at 3M surface gaussians
//   @1080p a per-block timeline showed the whole kernel (4.3 ms, H100) set
//   by light tiles of ~11k pairs at ~370 ns a pair, a 40k-pair heavy walk
//   ending at 3.3 ms, and the SMs mostly idle after the first millisecond.
// * Depth segments (split-K over the pairs), in a frame that has heavy
//   tiles: a tile of more than 2 L pairs if heavy, L / LIGHT_DIV if light,
//   is cut into segments of L = cap / SEG_DIV pairs (render/plan.py;
//   rounded up to `chunk`, so segment borders are batch borders), each
//   walked by a cluster of its own.  A segment composites its pairs from
//   T = 1, C = 0 with the cluster's votes, and stops once every one of its
//   pixels has local T < alpha_min: the tile's T there is the prefix's
//   times the local one, so the tile has exited by then.  It keeps its
//   per-pixel (C, T) in a scratch slot.  The segments are laid out round by
//   round (every cut tile's segment 0, then every segment 1, ...), so a
//   tile's later segments start after its earlier ones; the cluster that
//   holds a tile's merge lock (taken by a try: no block ever waits on
//   another cluster) folds the stored segments front to back into the
//   prefix, C <- C + T * C_k, T <- T * T_k, up to the first segment k
//   after which every pixel has T < alpha_min (T never rises, so the tile
//   cannot have ended before k).  Segment 0 starts from the true prefix,
//   so its own stop is the tile's exit; for 0 < k the cluster walks
//   segment k again from the prefix before it, with the votes, which ends
//   at the plain walk's exit batch.  Once k is known, the segments past it
//   are skipped, or stop at their next batch.  A tile that never exits
//   merges every segment.  At 3M surface gaussians the kernel then keeps
//   its SMs full until near its end (2.2 ms against 4.4, H100), bound by
//   the pairs walked, of which the segments past an exit that started
//   before it was known are still the largest waste.
//   The clusters of the heavy tiles walked whole come first in the grid,
//   then the segments, then the light tiles left whole.
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
// the full-precision one, so kernel and plain version round alike.  A tile
// cut into depth segments departs from that order only at the merge, which
// reassociates the sum over the segments before the exit segment.

#include <cooperative_groups.h>

#include "raster_common.cuh"

namespace cg = cooperative_groups;

// A block's vote word, written by its owner and read by the other blocks of
// the cluster through distributed shared memory, as strong (relaxed)
// accesses at cluster scope: single-copy atomic and coherent among the
// cluster's threads.  The word is all that crosses between the blocks, no
// other memory is read on the strength of it, so there is nothing for a
// release / acquire pair to order; its fences cost 5% of the kernel at 1M
// surface gaussians @1080p on an H100 (a sweep of kernel variants when the
// split tiles were written, variant release_acquire_votes).
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
  // depth segments (raster_common.cuh's SegPlan): the plan's words and
  // lists, each tile's merge state, each slot's stored flag, and the
  // scratch slots, each THREADS * PPT (C, T) pixels
  int32_t* seg_words;
  const int32_t* seg_whole;
  const int32_t* seg_cut;
  const int32_t* seg_first;
  const int32_t* seg_rounds;
  int32_t* seg_state;
  int32_t* seg_stored;
  float4* seg_scratch;
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

// A thread's pixels of a walk: lane l of warp v of pixel group `group`
// holds the pixel slots pw + 32 * i, pw = group * THREADS * P + v * 32 * P
// + l, with their (C, T); slots past the tile hold T = 0 and never vote.
template <int P>
struct Pixels {
  float px[P], py[P], cr[P], cg_[P], cb[P], tr[P];
  bool on[P];
};

__device__ __forceinline__ int first_slot(int group, int P) {
  return group * THREADS * P + (threadIdx.x >> 5) * 32 * P +
         (threadIdx.x & 31);
}

template <int P, bool GROUPED>
__device__ __forceinline__ void pixels_init(const RasterArgs& a, int t,
                                            int group, Pixels<P>& q) {
  const int npix = a.tile_w * a.tile_h;
  const int x0 = (t % a.tiles_x) * a.tile_w;
  const int y0 = (t / a.tiles_x) * a.tile_h;
  const int pw = first_slot(group, P);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = pw + i * 32;
    int x, y;
    slot_xy<GROUPED>(a, p, &x, &y);
    q.on[i] = p < npix;
    q.px[i] = (float)(x0 + x);
    q.py[i] = (float)(y0 + y);
    q.cr[i] = q.cg_[i] = q.cb[i] = 0.f;
    q.tr[i] = q.on[i] ? 1.f : 0.f;  // slots past the tile never vote
  }
}

// The pairs [s, e) of tile t's sorted range, in the batches of `chunk`
// that start at absolute multiples of it, composited into q.  With
// CLUSTER, the tile's blocks form a cluster and vote together on where the
// walk ends; GROUPED: the slots are laid out group by group, and each pixel
// group also stops on its own.  Every block of a cluster calls it with the
// same [s, e).  CANCEL: depth segment `seg` of its tile, which also stops
// once *exit_seg, the segment that holds the tile's exit, is known to be
// an earlier one (every block sees it sooner or later, so the votes agree).
template <int P, bool CLUSTER, bool GROUPED, bool CANCEL = false>
__device__ __forceinline__ void walk_pairs(const RasterArgs& a, int t,
                                           int group, int nsplit, int s,
                                           int e, Pixels<P>& q, float4* smem,
                                           int* vote, unsigned* gvote,
                                           const int* exit_seg = nullptr,
                                           int seg = 0) {
  constexpr bool VOTES = CLUSTER;
  const int npix = a.tile_w * a.tile_h;
  const int x0 = (t % a.tiles_x) * a.tile_w;
  const int y0 = (t / a.tiles_x) * a.tile_h;
  const int base = group * THREADS * P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Strip st;
  if constexpr (GROUPED) {
    st = group_strip<P>(a, base, npix, x0, y0);
  } else {
    st = warp_strip<P>(base, npix, a.tile_w, x0, y0);
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
      for (int j = threadIdx.x; j < hi; j += THREADS)
        stage_pair(smem + 3 * j, a.feats, a.kp, k0 + j);
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
            const int j = q0 + __ffs(hits) - 1;
            hits &= hits - 1;
            const float4 g0 = smem[3 * j];
            const float4 g1 = smem[3 * j + 1];
            const float4 g2 = smem[3 * j + 2];
#pragma unroll
            for (int i = 0; i < P; ++i) {
              if (!q.on[i]) continue;
              if (GROUPED && !((live >> unit_of<P>(i)) & 1u)) continue;
              const Alpha al =
                  pair_alpha(q.px[i], q.py[i], g0, g1, a.alpha_clamp,
                             a.alpha_min, a.use_bbox);
              if (!al.keep) continue;
              const float w = __fmul_rn(al.alpha, q.tr[i]);
              q.cr[i] = __fadd_rn(q.cr[i], __fmul_rn(w, g2.x));
              q.cg_[i] = __fadd_rn(q.cg_[i], __fmul_rn(w, g2.y));
              q.cb[i] = __fadd_rn(q.cb[i], __fmul_rn(w, g2.z));
              q.tr[i] = __fmul_rn(q.tr[i], __fsub_rn(1.f, al.alpha));
            }
          }
        }
      }
    }
    float tmax = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) tmax = fmaxf(tmax, q.tr[i]);
    int go;
    if constexpr (GROUPED) {
      // each group's flag: some pixel of it still has T >= gstop
      unsigned mine = 0u;
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (q.tr[i] >= gstop) mine |= 1u << unit_of<P>(i);
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
    } else if constexpr (CANCEL) {
      go = __syncthreads_or(tmax >= a.alpha_min &&
                            *(const volatile int*)exit_seg >= seg);
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
}

// The image's pixels of q: clip(C + T * background), and clip(1 - T).
template <int P, bool GROUPED>
__device__ __forceinline__ void pixels_write(const RasterArgs& a, int t,
                                             int group, const Pixels<P>& q) {
  const int x0 = (t % a.tiles_x) * a.tile_w;
  const int y0 = (t / a.tiles_x) * a.tile_h;
  const int pw = first_slot(group, P);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    int x, y;
    slot_xy<GROUPED>(a, pw + i * 32, &x, &y);
    x += x0;
    y += y0;
    if (!q.on[i] || x >= a.W || y >= a.H) continue;
    float* o = a.out + ((int64_t)y * a.W + x) * a.nchan;
    o[0] = fminf(fmaxf(__fadd_rn(q.cr[i], __fmul_rn(q.tr[i], a.bg0)), 0.f),
                 1.f);
    o[1] = fminf(fmaxf(__fadd_rn(q.cg_[i], __fmul_rn(q.tr[i], a.bg1)), 0.f),
                 1.f);
    o[2] = fminf(fmaxf(__fadd_rn(q.cb[i], __fmul_rn(q.tr[i], a.bg2)), 0.f),
                 1.f);
    if (a.nchan == 4)
      o[3] = fminf(fmaxf(__fsub_rn(1.f, q.tr[i]), 0.f), 1.f);
  }
}

// K2 for the pixel slots [group * THREADS * P, (group + 1) * THREADS * P)
// of tile t, over its whole pair range.
template <int P, bool CLUSTER, bool GROUPED>
__device__ __forceinline__ void raster_walk(const RasterArgs& a, int t,
                                            int group, int nsplit,
                                            float4* smem, int* vote,
                                            unsigned* gvote) {
  Pixels<P> q;
  pixels_init<P, GROUPED>(a, t, group, q);
  walk_pairs<P, CLUSTER, GROUPED>(a, t, group, nsplit, a.tile_start[t],
                                  a.tile_end[t], q, smem, vote, gvote);
  pixels_write<P, GROUPED>(a, t, group, q);
}

// One block's work: a tile, its pixel group among `split`, and which of
// its depth segments (slot < 0: the tile walked whole).
struct K2Work {
  int tile, group, split, seg, slot, nseg;
};

// K2's work list (raster_common.cuh's raster_plan_kernel<true>): clusters
// of `split` blocks take the heavy tiles walked whole, then the segments
// round by round; the blocks after them one light tile each, in `order`,
// but for the light tiles cut into segments.
__device__ __forceinline__ bool k2_work_of(const RasterArgs& a,
                                           const int32_t* __restrict__ order,
                                           const int32_t* __restrict__ nheavy,
                                           int num_tiles, int split,
                                           K2Work* w) {
  const int q = blockIdx.x / split, r = blockIdx.x % split;
  const int nw = a.seg_words[0], ns = a.seg_words[3];
  if (q < nw) {
    *w = {a.seg_whole[q], r, split, 0, -1, 1};
    return true;
  }
  if (q < nw + ns) {
    // round j: the last with rounds[j] <= the segment's index
    const int k = q - nw;
    int j = 0, hi = a.seg_words[5] - 1;
    while (j < hi) {
      const int mid = (j + hi + 1) >> 1;
      if (a.seg_rounds[mid] <= k) j = mid; else hi = mid - 1;
    }
    const int p = k - a.seg_rounds[j];
    const int t = a.seg_cut[p];
    const int s = a.tile_start[t], len = a.seg_words[1];
    const int n = (int)(((long long)a.tile_end[t] - (s - s % a.chunk) +
                         len - 1) / len);
    *w = {t, r, split, j, a.seg_first[p] + j, n};
    return true;
  }
  const int i = *nheavy + (q - nw - ns) * split + r;
  if (i >= num_tiles) return false;
  const int t = order[i];
  if (segments_of(a.tile_start[t], a.tile_end[t], a.chunk, a.seg_words[1],
                  a.seg_words[2]) > 0)
    return false;
  *w = {t, 0, 1, 0, -1, 1};
  return true;
}

// One depth segment of a tile, by the cluster of its pixel groups: its
// pairs from T = 1, C = 0 into its scratch slot, unless the tile's exit is
// known to lie in an earlier segment.  Then the cluster that holds the
// tile's merge lock (taken by a try, never waited for) merges the stored
// segments front to back into the prefix, kept in the tile's first slot,
// up to the first segment after which every pixel has T < alpha_min: it
// walks that one again from the prefix before it (segment 0's own walk
// already stopped at the exit) and writes the tile's pixels, as does the
// merge of a tile's last segment where the tile never exits.  A holder
// that finds the next segment not stored yet releases the lock and looks
// once more (its release and the finisher's flag are each followed by a
// full fence, so one of the two sees the other's store).  hand[4]: this
// block's words of the hand-off.
template <int P>
__device__ __forceinline__ void raster_segment(const RasterArgs& a,
                                               const K2Work& w, float4* smem,
                                               int* vote, unsigned* gvote,
                                               int* hand) {
  cg::cluster_group cl = cg::this_cluster();
  const bool lead = threadIdx.x == 0 && cl.block_rank() == 0;
  const int t = w.tile, ns = w.nseg, j = w.seg;
  // the tile's segments merged, its merge lock, its exit's segment
  int* state = a.seg_state + 3 * t;
  const volatile int* exit_seg = state + 2;
  // segment j: the pairs [max(s, b0 + j * len), min(e, b0 + (j + 1) *
  // len)), b0 = s rounded down to a multiple of chunk
  auto lo = [&](int k) {
    const int s = a.tile_start[t];
    return (int)max((long long)s,
                    s - s % a.chunk + (long long)k * a.seg_words[1]);
  };
  auto hi = [&](int k) {
    const int s = a.tile_start[t];
    return (int)min((long long)a.tile_end[t],
                    s - s % a.chunk + (long long)(k + 1) * a.seg_words[1]);
  };
  // the lead block's thread 0 tells every block of the cluster; it tells
  // again only after a cluster barrier that follows every block's read
  auto tell = [&](int at, int v) {
    for (int r = 0; r < w.split; ++r) *cl.map_shared_rank(&hand[at], r) = v;
  };
  cl.sync();  // every block of the cluster runs before the lead writes
  if (lead) tell(0, *exit_seg < j);
  cl.sync();
  if (hand[0]) return;  // past the tile's exit: not needed
  Pixels<P> q;
  pixels_init<P, false>(a, t, w.group, q);
  walk_pairs<P, true, false, true>(a, t, w.group, w.split, lo(j), hi(j), q,
                                   smem, vote, gvote, state + 2, j);
  if (ns == 1) {  // the tile's one segment: its walk is the tile's
    pixels_write<P, false>(a, t, w.group, q);
    return;
  }
  if (lead) tell(0, *exit_seg < j);
  cl.sync();
  if (hand[0]) return;  // cancelled, or past the exit
  const int stride = w.split * THREADS * P;
  const int pw = first_slot(w.group, P);
  const int slot0 = w.slot - j;  // the tile's first slot: the prefix
  float4* mine = a.seg_scratch + (size_t)slot0 * stride + pw;
#pragma unroll
  for (int i = 0; i < P; ++i)
    mine[(size_t)j * stride + i * 32] =
        make_float4(q.cr[i], q.cg_[i], q.cb[i], q.tr[i]);
  __threadfence();
  cl.sync();
  if (lead) {
    atomicExch(&a.seg_stored[w.slot], 1);
    __threadfence();
  }
  for (;;) {
    if (lead) {
      const int took = atomicCAS(&state[1], 0, 1) == 0;
      __threadfence();
      tell(0, took);
      tell(1, took ? *(volatile int*)&state[0] : 0);
    }
    cl.sync();
    const int got = hand[0];
    int f = hand[1];
    cl.sync();  // read by every block before the lead tells again
    if (!got) return;  // another cluster merges: it will see our slot
    for (;; ++f) {
      if (lead) tell(0, *(volatile int*)&a.seg_stored[slot0 + f]);
      cl.sync();
      if (!hand[0]) break;  // segment f is not stored yet
      __threadfence();
      // the prefix before f (u) and through f (q)
      float ur[P], ug[P], ub[P], ut[P];
      float tmax = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float4 v = __ldcg(mine + (size_t)f * stride + i * 32);
        const float4 u = f ? __ldcg(mine + i * 32)
                           : make_float4(0.f, 0.f, 0.f, q.on[i] ? 1.f : 0.f);
        ur[i] = u.x;
        ug[i] = u.y;
        ub[i] = u.z;
        ut[i] = u.w;
        q.cr[i] = __fadd_rn(u.x, __fmul_rn(u.w, v.x));
        q.cg_[i] = __fadd_rn(u.y, __fmul_rn(u.w, v.y));
        q.cb[i] = __fadd_rn(u.z, __fmul_rn(u.w, v.z));
        q.tr[i] = __fmul_rn(u.w, v.w);
        tmax = fmaxf(tmax, q.tr[i]);
      }
      const int live = __syncthreads_or(tmax >= a.alpha_min);
      if (threadIdx.x == 0) hand[2] = live;
      cl.sync();
      if (threadIdx.x == 0) {
        int any = 0;
        for (int r = 0; r < w.split; ++r)
          any |= *cl.map_shared_rank(&hand[2], r);
        hand[3] = any;
      }
      cl.sync();  // every block has read the others' hand[2]
      if (!hand[3]) {  // the tile's exit lies in segment f
        if (f > 0) {   // walk it again from the prefix before it
#pragma unroll
          for (int i = 0; i < P; ++i) {
            q.cr[i] = ur[i];
            q.cg_[i] = ug[i];
            q.cb[i] = ub[i];
            q.tr[i] = ut[i];
          }
          if (lead) atomicAdd(&a.seg_words[4], 1);
          walk_pairs<P, true, false>(a, t, w.group, w.split, lo(f), hi(f),
                                     q, smem, vote, gvote);
        }
        pixels_write<P, false>(a, t, w.group, q);
        if (lead) atomicExch(&state[2], f);
        return;  // the lock stays taken: the tile is done
      }
      if (f + 1 == ns) {  // every segment merged: the tile never exits
        pixels_write<P, false>(a, t, w.group, q);
        return;
      }
      if (f > 0) {
#pragma unroll
        for (int i = 0; i < P; ++i)
          mine[i * 32] = make_float4(q.cr[i], q.cg_[i], q.cb[i], q.tr[i]);
      }
    }
    // merged through f - 1: release the lock, then look once more
    __threadfence();
    cl.sync();
    if (lead) {
      *(volatile int*)&state[0] = f;
      __threadfence();
      atomicExch(&state[1], 0);
      __threadfence();
      tell(0, *(volatile int*)&a.seg_stored[slot0 + f]);
    }
    cl.sync();
    const int again = hand[0];
    cl.sync();  // read by every block before the lead tells again
    if (!again) return;
  }
}

// One launch's blocks: each takes its tile (and pixel group, and depth
// segment) from the work list.  SUBTILE: heavy tiles take the grouped walk
// (grouped_tile) and no tile is cut into segments; without it the kernel
// holds the whole-tile walks and the segments.
template <int PPT, bool SUBTILE>
__device__ __forceinline__ void raster_tiles(
    const RasterArgs& a, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nheavy, int num_tiles, int groups) {
  extern __shared__ float4 smem[];  // [min(chunk, STAGE_PAIRS)][3]
  __shared__ int vote[2];
  __shared__ unsigned gvote[2];
  __shared__ int hand[4];
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
  K2Work w;
  if (!k2_work_of(a, order, nheavy, num_tiles, S, &w)) return;
  if constexpr (S > 1) {
    if (w.split > 1) {  // uniform over the cluster
      if constexpr (SUBTILE) {
        if (grouped_tile(a, w.tile)) {
          raster_walk<PPT / S, true, true>(a, w.tile, w.group, S, smem, vote,
                                           gvote);
          return;
        }
      } else {
        if (w.slot >= 0) {
          raster_segment<PPT / S>(a, w, smem, vote, gvote, hand);
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

// Resident blocks an SM that a kernel of PPT pixels a thread is compiled
// for: 4 up to 4 pixels a thread (64 registers), as many as the registers
// of the larger ones allow.  Unbounded, the compiler also kept
// raster_kernel<4, false> at 64 registers, but laid out its spills such
// that its light tiles ran 4.7% slower once the segments' code joined the
// kernel (0.534 against 0.513 ms at 1M random gaussians @1080p, H100).
__host__ __device__ constexpr int min_blocks(int ppt) {
  return ppt <= 4 ? 4 : ppt == 8 ? 2 : 1;
}

template <int PPT, bool SUBTILE>
__global__ void __launch_bounds__(THREADS, min_blocks(PPT)) raster_kernel(
    RasterArgs a, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nheavy, int num_tiles, int groups) {
  raster_tiles<PPT, SUBTILE>(a, order, nheavy, num_tiles, groups);
}

// The grouped walk takes K2<4> past 64 registers (to 80 as first
// written): 3 blocks an SM where the whole-tile kernel keeps 4, and light
// tiles 4% slower (0.529 against 0.507 ms at 1M random gaussians @1080p,
// H100).  Held to 4 blocks it spills 84 bytes, runs light tiles as fast
// as the whole-tile kernel and the surface frame's heavy ones 0.8% faster
// (a sweep of kernel variants when subtile_exit was ported: variant
// subtile_blocks_3 is the kernel without the bound).
__global__ void __launch_bounds__(THREADS, 4) raster_kernel_subtile4(
    RasterArgs a, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nheavy, int num_tiles, int groups) {
  raster_tiles<4, true>(a, order, nheavy, num_tiles, groups);
}

// `clusters` clusters of split_of(PPT) blocks, or with `groups` > 1 one
// cluster of `groups` blocks a tile.
template <int PPT>
static cudaError_t launch(const RasterArgs& a, const int32_t* order,
                          const int32_t* nheavy, int num_tiles, int groups,
                          int clusters, cudaStream_t st) {
  const int S = blocks_per_tile(PPT, groups);
  const int staged = a.chunk < STAGE_PAIRS ? a.chunk : STAGE_PAIRS;
  const size_t smem = (size_t)3 * sizeof(float4) * staged;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups > 1 ? num_tiles : clusters) * S);
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

// Builds the work list in `work` (int32: order[num_tiles], nheavy[1],
// words[8], whole[max_ent], cut[num_tiles], first[num_tiles],
// rounds[SEG_ROUNDS], state[3 * num_tiles], stored[max_segs]), then
// composites.  The grid holds max_ent clusters of heavy tiles and segments
// and the light tiles after them; depth segments (seg_div > 0, neither
// subtile_exit nor several blocks a tile) keep their (C, T) in
// scratch[max_segs][THREADS * ppt].
extern "C" int splat_rasterize(const void* tile_start, const void* tile_end,
                               void* work, void* scratch, const void* feats,
                               int64_t kp, void* out, int H, int W,
                               int tile_w, int tile_h, int tiles_x,
                               int num_tiles, int chunk, float alpha_clamp,
                               float alpha_min, float bg0, float bg1,
                               float bg2, int nchan, int use_bbox, int ppt,
                               int groups, int slots, int min_pairs,
                               int group_cols, int heavy_pairs, int seg_div,
                               int light_div, int max_ent, int max_segs,
                               void* stream) {
  const int nt = num_tiles;
  int32_t* o = (int32_t*)work;
  int32_t* nh = o + nt;
  int32_t* words = nh + 1;
  int32_t* whole = words + 8;
  int32_t* cut = whole + max_ent;
  int32_t* first = cut + nt;
  int32_t* rounds = first + nt;
  int32_t* state = rounds + SEG_ROUNDS;
  int32_t* stored = state + 3 * nt;
  const RasterArgs a = {(const int32_t*)tile_start, (const int32_t*)tile_end,
                        (const float*)feats, kp, (float*)out, H, W, tile_w,
                        tile_h, tiles_x, chunk, alpha_clamp, alpha_min, bg0,
                        bg1, bg2, nchan, use_bbox, group_cols, heavy_pairs,
                        words, whole, cut, first, rounds, state, stored,
                        (float4*)scratch};
  // group_cols > 0 (subtile_exit) needs a tile of whole 8 x 16 groups
  if (group_cols < 0 || (group_cols > 0 && (group_cols * GROUP_W != tile_w ||
                                            tile_h % GROUP_H != 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!valid_launch(ppt, groups) || max_ent < 0 || max_segs < 0 ||
      (max_segs > 0 && (seg_div < 1 || light_div < 1 || group_cols > 0 ||
                        groups > 1 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int split = plan_split(ppt, groups);
  // the exit ends a walk early, and where is not known before the launch:
  // the plan goes by the tile's pairs, an upper bound of its walk
  const SegPlan sp = {words, whole, cut, first, rounds, state, stored,
                      chunk, max_segs > 0 ? seg_div : 0, light_div,
                      max_ent, max_segs};
  const cudaError_t err = plan_segmented(a.tile_start, a.tile_end, nt, split,
                                         slots, min_pairs, o, nh, sp, st);
  if (err != cudaSuccess) return (int)err;
  // the clusters of heavy tiles and segments, then the light tiles
  // split_of(ppt) a cluster
  const int c = max_ent + (nt + split - 1) / split, g = groups;
  switch (ppt) {
    case 1: return (int)launch<1>(a, o, nh, nt, g, c, st);
    case 2: return (int)launch<2>(a, o, nh, nt, g, c, st);
    case 4: return (int)launch<4>(a, o, nh, nt, g, c, st);
    case 8: return (int)launch<8>(a, o, nh, nt, g, c, st);
    case 16: return (int)launch<16>(a, o, nh, nt, g, c, st);
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
