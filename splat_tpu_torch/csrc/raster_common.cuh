// What the three raster kernels share: K2 (csrc/raster.cu), K3 and K4
// (csrc/raster_train.cu).
//
// * a pair's features staged in shared memory as three float4;
// * one pair's alpha at one pixel, in explicitly rounded operations, in the
//   order of the plain versions (render/kernels.py, render/diff.py);
// * a warp's compact strip of tile pixels and the exact test of a pair's box
//   against it, which lets a warp skip pairs none of its pixels can keep;
// * the work list: which tile, and which of its pixel groups, a block takes,
//   and the small kernel that builds the list on the device before each
//   launch (render/plan.py holds its plain version); for K2 the list also
//   cuts the longest tiles into depth segments.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define THREADS 256
#define FULL 0xffffffffu

// Blocks per heavy tile (plan.py's _split): each keeps >= 1 pixel a thread.
__host__ __device__ constexpr int split_of(int ppt) {
  return ppt < 4 ? ppt : 4;
}

// The most pixels a thread holds.  A tile of more than THREADS * MAX_PPT
// pixels takes `groups` blocks of MAX_PPT (render/kernels.py::_ppt), at most
// MAX_GROUPS: K2's and K3's blocks of one tile vote as a thread-block
// cluster, and a portable cluster holds at most 8 blocks.
#define MAX_PPT 16
#define MAX_GROUPS 8

// Pairs staged in shared memory at a time (48 bytes each: 48,000 bytes, in
// the 48 KB a block gets without opting in).  A batch or window of more
// than `chunk` pairs is staged in parts; its exit vote still comes after
// the whole batch or window.
#define STAGE_PAIRS 1000

// The launch's grid and cluster width: `groups` blocks a tile for a tile of
// several pixel groups, else the heavy-tile split of `ppt`; and the split
// the work list plans for (none where every tile takes `groups` blocks).
static inline int blocks_per_tile(int ppt, int groups) {
  return groups > 1 ? groups : split_of(ppt);
}
static inline int plan_split(int ppt, int groups) {
  return groups > 1 ? 1 : split_of(ppt);
}
static inline bool valid_launch(int ppt, int groups) {
  return ppt >= 1 && groups >= 1 && groups <= MAX_GROUPS &&
         (groups == 1 || ppt == MAX_PPT);
}

// A pair's features in shared memory, as three float4:
// {cx, cy, rx^2, ry^2}, {a2, b2, c2, opacity}, {r, g, b, 0}.
__device__ __forceinline__ void stage_pair(float4* dst,
                                           const float* __restrict__ feats,
                                           int64_t kp, int64_t k) {
  dst[0] = make_float4(feats[k], feats[kp + k], feats[9 * kp + k],
                       feats[10 * kp + k]);
  dst[1] = make_float4(feats[2 * kp + k], feats[3 * kp + k],
                       feats[4 * kp + k], feats[8 * kp + k]);
  dst[2] = make_float4(feats[5 * kp + k], feats[6 * kp + k],
                       feats[7 * kp + k], 0.f);
}

struct Alpha {
  float dx, dy, dx2, dy2, expp, a_raw, alpha;
  bool keep;
};

// One pair's alpha at one pixel, as the plain versions compute it.
__device__ __forceinline__ Alpha pair_alpha(float px, float py, float4 g0,
                                            float4 g1, float alpha_clamp,
                                            float alpha_min, int use_bbox) {
  Alpha a;
  a.dx = __fsub_rn(px, g0.x);
  a.dy = __fsub_rn(g0.y, py);
  a.dx2 = __fmul_rn(a.dx, a.dx);
  a.dy2 = __fmul_rn(a.dy, a.dy);
  const float power =
      __fadd_rn(__fadd_rn(__fmul_rn(g1.x, a.dx2), __fmul_rn(g1.z, a.dy2)),
                __fmul_rn(g1.y, __fmul_rn(a.dx, a.dy)));
  a.expp = expf(power);
  a.a_raw = __fmul_rn(g1.w, a.expp);
  a.alpha = fminf(alpha_clamp, a.a_raw);
  a.keep = a.alpha >= alpha_min;
  if (use_bbox) a.keep = a.keep && a.dx2 <= g0.z && a.dy2 <= g0.w;
  return a;
}

// The pixel rectangle that holds a warp's strip (tile pixels
// [pa, pb]); `any` is false when the warp holds no tile pixel.
struct Strip {
  float xa, xb, ya, yb;
  bool any;
};

template <int P>
__device__ __forceinline__ Strip warp_strip(int base, int npix, int tile_w,
                                            int x0, int y0) {
  Strip st;
  const int pa = base + (threadIdx.x >> 5) * 32 * P;
  const int pb = min(pa + 32 * P, npix) - 1;
  st.any = pa < npix;
  const int ra = pa / tile_w, rb = pb / tile_w;
  st.xa = (float)(x0 + (ra == rb ? pa % tile_w : 0));
  st.xb = (float)(x0 + (ra == rb ? pb % tile_w : tile_w - 1));
  st.ya = (float)(y0 + ra);
  st.yb = (float)(y0 + rb);
  return st;
}

// The least squared offset, rounded as pair_alpha rounds it, from c to an
// integer pixel coordinate in [lo, hi]: the offset grows on either side of
// c, so the nearest integer below or above c (clamped) is the minimum.
__device__ __forceinline__ float nearest_d2(float c, float lo, float hi) {
  const float f = floorf(c);
  const float a = __fsub_rn(fminf(fmaxf(f, lo), hi), c);
  const float b = __fsub_rn(fminf(fmaxf(f + 1.f, lo), hi), c);
  return fminf(__fmul_rn(a, a), __fmul_rn(b, b));
}

// False only if no pixel of the strip passes the pair's box test, so no
// pixel keeps the pair (a NaN centre fails both tests alike).
__device__ __forceinline__ bool strip_reaches(const Strip& st, float4 g0) {
  return nearest_d2(g0.x, st.xa, st.xb) <= g0.z &&
         nearest_d2(g0.y, st.ya, st.yb) <= g0.w;
}

// Which tile, and which of its pixel groups, a block takes: the first
// nheavy clusters of `split` blocks each take one heavy tile, the blocks
// after them one light tile each, in `order` (longest walk first).
struct Work {
  int tile, group, split;
};

__device__ __forceinline__ bool work_of(const int32_t* __restrict__ order,
                                        const int32_t* __restrict__ nheavy,
                                        int num_tiles, int split, Work* w) {
  const int q = blockIdx.x / split, r = blockIdx.x % split;
  const int nh = *nheavy;
  if (q < nh) {
    *w = {order[q], r, split};
    return true;
  }
  const int i = nh + (q - nh) * split + r;
  if (i >= num_tiles) return false;
  *w = {order[i], 0, 1};
  return true;
}

#define PLAN_THREADS 1024
#define PLAN_BUCKETS 1024

// K2's depth segments (csrc/raster.cu), planned after the work list by the
// same kernel, in a frame that has heavy tiles: a tile is cut into segments
// of `len` pairs where it holds more than `over` pairs, 2 * len for a heavy
// tile (whose blocks walk one pixel a thread) and len / light_div for a
// light one (whose one block walks several pixels a thread, each pair the
// slower); segment j holds the pairs [base + j * len, base + (j + 1) * len)
// of [start, end), base being start rounded down to a multiple of `chunk`.
// `len` is cap / seg_div rounded up to a multiple of `chunk`, so segment
// borders are batch borders.  The clusters of a launch take, in order: the
// heavy tiles walked whole (`whole`, in the list's order), then the
// segments round by round, round r holding segment r of every tile cut
// into more than r (`cut`: the cut tiles, most segments first, so that
// round r's tiles are a prefix of it; `rounds[r]`: the segments before
// round r), then the light tiles left whole.  A tile's later segments thus
// start after its earlier ones, and those past its exit, once the merge
// has found it, are skipped.  `first`: each cut tile's first scratch slot.
// seg_div 0 plans no segment; nor where the segments would outgrow what
// the caller sized (max_ent clusters of heavy tiles and segments, max_segs
// scratch slots) or a tile would take SEG_ROUNDS segments or more.
// render/plan.py::_segments is the plain version.
#define SEG_ROUNDS 1024
static_assert(SEG_ROUNDS == PLAN_THREADS, "one round a plan thread");
struct SegPlan {
  // [0] heavy tiles walked whole, [1] len (0: none), [2] light tiles'
  // `over`, [3] segments planned, [4] segments re-walked at an exit
  // (counted by K2), [5] rounds
  int32_t* words;
  int32_t* whole;   // [max_ent]
  int32_t* cut;     // [num_tiles]
  int32_t* first;   // [num_tiles]
  int32_t* rounds;  // [SEG_ROUNDS]
  // per tile: segments merged, merge lock, segment of the exit (INT_MAX:
  // not known); per scratch slot: its segment is stored (K2's merge)
  int32_t* state;
  int32_t* stored;
  int chunk, seg_div, light_div, max_ent, max_segs;
};

// A tile's segments where it is cut above `over` pairs: 0 where it is
// walked whole.
__device__ __forceinline__ int segments_of(int s, int e, int chunk, int len,
                                           long long over) {
  if (len <= 0 || (long long)e - s <= over) return 0;
  const int base = s - s % chunk;
  return (int)(((long long)e - base + len - 1) / len);
}

// Exclusive prefix sum of v over the plan kernel's threads, and the total.
__device__ __forceinline__ long long plan_scan(long long v, long long* total,
                                               long long* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long up = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += up;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  const long long excl = incl - v + (warp ? warp_sum[warp - 1] : 0);
  *total = warp_sum[PLAN_THREADS / 32 - 1];
  __syncthreads();  // warp_sum is free again
  return excl;
}

// The segments of the tiles, by the whole block, once `order` is built
// (its first nh tiles heavy).
__device__ __forceinline__ void plan_segments(
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_end, int num_tiles,
    const int32_t* order, int nh, long long cap, const SegPlan& sp) {
  __shared__ long long warp_sum[PLAN_THREADS / 32];
  // cut tiles by their segments, then the cursor of each count in `cut`
  __shared__ int hist[SEG_ROUNDS];
  __shared__ int above[SEG_ROUNDS];  // cut tiles of more segments
  __shared__ int slots_above[SEG_ROUNDS];  // and their segments
  __shared__ int most, too_many;
  const int tid = threadIdx.x;
  for (int t = tid; t < num_tiles; t += PLAN_THREADS) {
    sp.state[3 * t] = 0;
    sp.state[3 * t + 1] = 0;
    sp.state[3 * t + 2] = INT_MAX;
  }
  for (int r = tid; r < SEG_ROUNDS; r += PLAN_THREADS) hist[r] = 0;
  if (tid == 0) most = too_many = 0;
  int len = 0, light = 0;
  // no heavy tile, no segment (render/plan.py::_segments: cutting such a
  // frame's light tiles made K2 slower)
  if (sp.seg_div > 0 && nh > 0) {
    const long long l = max(cap / sp.seg_div, 1LL);
    len = (int)((l + sp.chunk - 1) / sp.chunk * sp.chunk);
    light = max(len / sp.light_div, 1);
  }
  __syncthreads();
  auto cut_of = [&](int i) {
    const int t = order[i];
    return segments_of(tile_start[t], tile_end[t], sp.chunk, len,
                       i < nh ? 2LL * len : (long long)light);
  };
  // what the segments need, against what the caller sized
  long long nw = 0, n = 0, tw, ts;
  for (int i = tid; i < num_tiles; i += PLAN_THREADS) {
    const int k = cut_of(i);
    if (k >= SEG_ROUNDS) {
      too_many = 1;
    } else if (k > 0) {
      atomicAdd(&hist[k], 1);
      atomicMax(&most, k);
    }
    nw += i < nh && k == 0;
    n += k;
  }
  plan_scan(nw, &tw, warp_sum);
  plan_scan(n, &ts, warp_sum);
  if (too_many || tw + ts > sp.max_ent || ts > sp.max_segs) len = 0;
  const int m = len ? most : 0;  // rounds; uniform
  // above[v], slots_above[v]: the cut tiles of more than v segments, and
  // their segments
  const int v = SEG_ROUNDS - 1 - tid;
  long long unused;
  const int h = len && v > 0 ? hist[v] : 0;
  const int a = (int)plan_scan(h, &unused, warp_sum);
  const int sa = (int)plan_scan((long long)h * v, &unused, warp_sum);
  above[v] = a;
  slots_above[v] = sa;
  __syncthreads();
  // rounds[r]: the segments of the rounds before r, one a cut tile of more
  // than r' segments for each r' < r
  const long long rb = plan_scan(tid <= m ? above[tid] : 0, &unused,
                                 warp_sum);
  if (tid <= m) sp.rounds[tid] = (int)rb;
  hist[tid] = above[tid];  // the cursor of each count
  __syncthreads();
  long long wbase = 0;
  for (int i0 = 0; i0 < num_tiles; i0 += PLAN_THREADS) {
    const int i = i0 + tid;
    const int k = i < num_tiles ? cut_of(i) : 0;
    if (k > 0) {
      const int p = atomicAdd(&hist[k], 1);
      sp.cut[p] = order[i];
      sp.first[p] = slots_above[k] + (p - above[k]) * k;
    }
    long long tc;
    const long long e = plan_scan(i < nh && k == 0, &tc, warp_sum);
    if (i < nh && k == 0) sp.whole[wbase + e] = order[i];
    wbase += tc;
  }
  const long long segs = len ? ts : 0;
  for (long long q = tid; q < segs; q += PLAN_THREADS) sp.stored[q] = 0;
  if (tid == 0) {
    sp.words[0] = (int)wbase;
    sp.words[1] = len;
    sp.words[2] = light;
    sp.words[3] = (int)segs;
    sp.words[4] = 0;
    sp.words[5] = m;
  }
}

// The work list of one launch (plain version: render/plan.py::_tile_plan):
// tile ids into `order`, the tiles to split first (*nheavy of them), each
// group longest walk first to within a bucket.  Tile t plans to walk
// max(end[t] - start[t], 0) pairs: what it will walk, or an upper bound
// where an exit may end the walk early.  A tile is heavy where it walks more
// than min_pairs pairs and more than the frame's walk over `slots` resident
// blocks: unsplit, it would outlast the rest of the grid.  One block: a
// counting sort over 2 * PLAN_BUCKETS keys (heavy tiles take the first half
// of the keys; within a half, bucket (wmax - walk) * (PLAN_BUCKETS - 1) /
// wmax).  Built in the launch's own stream just before its kernel: no host
// sync, and one small kernel where a sort by PyTorch calls cost the host
// and an H100 0.14 ms a launch.  SEGMENTS (K2): then the depth segments of
// the heavy tiles (plan_segments).
template <bool SEGMENTS>
static __global__ void __launch_bounds__(PLAN_THREADS) raster_plan_kernel(
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_end, int num_tiles, int split, int slots,
    int min_pairs, int32_t* __restrict__ order, int32_t* __restrict__ nheavy,
    SegPlan sp) {
  __shared__ int start[2 * PLAN_BUCKETS];
  __shared__ int warp_total[PLAN_THREADS / 32];
  __shared__ unsigned long long pairs_sum;
  __shared__ int pairs_max;
  __shared__ int heavy_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    pairs_sum = 0;
    pairs_max = 0;
  }
  for (int i = tid; i < 2 * PLAN_BUCKETS; i += PLAN_THREADS) start[i] = 0;
  __syncthreads();
  long long sum = 0;
  int mx = 0;
  for (int t = tid; t < num_tiles; t += PLAN_THREADS) {
    const int wk = max(tile_end[t] - tile_start[t], 0);
    sum += wk;
    mx = max(mx, wk);
  }
  for (int o = 16; o; o >>= 1) {
    sum += __shfl_xor_sync(FULL, sum, o);
    mx = max(mx, __shfl_xor_sync(FULL, mx, o));
  }
  if (lane == 0) {
    atomicAdd(&pairs_sum, (unsigned long long)sum);
    atomicMax(&pairs_max, mx);
  }
  __syncthreads();
  const long long cap =
      max((long long)min_pairs, (long long)(pairs_sum / (unsigned)slots));
  const int wmax = pairs_max;
  auto key_of = [&](int t) {
    const int wk = max(tile_end[t] - tile_start[t], 0);
    const int b = (int)((long long)(wmax - wk) * (PLAN_BUCKETS - 1) /
                        max(wmax, 1));
    return split > 1 && wk > cap ? b : PLAN_BUCKETS + b;
  };
  for (int t = tid; t < num_tiles; t += PLAN_THREADS)
    atomicAdd(&start[key_of(t)], 1);
  __syncthreads();
  // exclusive scan of the 2 * PLAN_BUCKETS counts, two neighbours a thread
  const int c0 = start[2 * tid], c1 = start[2 * tid + 1];
  int incl = c0 + c1;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_total[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += up;
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  const int excl = incl - c0 - c1 + (warp ? warp_total[warp - 1] : 0);
  start[2 * tid] = excl;
  start[2 * tid + 1] = excl + c0;
  if (2 * tid == PLAN_BUCKETS) {  // tiles with a heavy key
    *nheavy = excl;
    heavy_count = excl;
  }
  __syncthreads();
  for (int t = tid; t < num_tiles; t += PLAN_THREADS)
    order[atomicAdd(&start[key_of(t)], 1)] = t;
  if constexpr (SEGMENTS) {
    __syncthreads();  // the list is written
    plan_segments(tile_start, tile_end, num_tiles, order, heavy_count, cap,
                  sp);
  }
}

// The work list of K3 and K4.
static inline cudaError_t plan_tiles(const int32_t* start, const int32_t* end,
                                     int num_tiles, int split, int slots,
                                     int min_pairs, int32_t* order,
                                     int32_t* nheavy, cudaStream_t st) {
  if (slots < 1) return cudaErrorInvalidValue;
  raster_plan_kernel<false><<<1, PLAN_THREADS, 0, st>>>(
      start, end, num_tiles, split, slots, min_pairs, order, nheavy,
      SegPlan{});
  return cudaGetLastError();
}

// K2's work list and its depth segments.
static inline cudaError_t plan_segmented(const int32_t* start,
                                         const int32_t* end, int num_tiles,
                                         int split, int slots, int min_pairs,
                                         int32_t* order, int32_t* nheavy,
                                         const SegPlan& sp, cudaStream_t st) {
  if (slots < 1) return cudaErrorInvalidValue;
  raster_plan_kernel<true><<<1, PLAN_THREADS, 0, st>>>(
      start, end, num_tiles, split, slots, min_pairs, order, nheavy, sp);
  return cudaGetLastError();
}
