// Pair expansion (K1): slots -> (tile << 32 | depth bits) sort keys.
//
// Replaces the TPU kernel splat_tpu/render/expand.py::_expand_kernel
// (one-hot owner recovery on the matrix unit).  The owner of slot k is the
// last gaussian g with first_slot[g] <= k (upper_bound - 1 over the
// exclusive prefix sum), so gaussians with zero tiles need no fake slots.
// From the owner: r = k - first_slot[g], the tile
// (ty0 + r / sw) * ntx + tx0 + r % sw and the 64-bit key: tile in the high
// word, the owner's f32 view depth bits in the low word (a positive float's
// bits order like the float).  Slots past min(total, k_cap) get the sentinel
// key num_tiles << 32 and owner 0.
//
// With a cull table (render/binning.py::cull_rows: per gaussian cx, cy, lam,
// thresh) the kernel also drops the dead pairs, as the TPU kernel's `cull`
// does: a slot whose tile's nearest pixel lies (dx, dy) from the owner's
// centre, with (dx*dx + dy*dy) * lam > thresh, gets the sentinel key and
// owner 0 too, so it sorts after every pair the raster kernel walks.  The
// bound is exact in f32 with margins (cull_rows), not the TPU's 8-px
// quantized one; thresh = +inf never culls.  The test is a template
// variant: without a table the kernel is the one it was.
//
// What bounds it on the card: bytes.  It must read 24 bytes a gaussian and
// write 16 bytes a slot (57 MB at 1M gaussians and 2.05M slots).  One search
// per slot over the whole prefix sum in global memory, ~log2(N) = 20
// dependent 8-byte loads a slot, moved several times that through the L2
// and was bound by their latency.
//
// What the design does about it: neighbouring slots have the same or the
// next owner.  A block takes SLOTS_PER_BLOCK consecutive slots.  Its two
// halves find the owners of its first and of its last slot together, each by
// a 128-way search (three rounds of one coalesced probe a thread at 1M
// gaussians instead of 20 dependent loads).  The block then copies
// first_slot[g_lo .. g_hi], relative to its first slot, into shared memory
// with coalesced loads, and every slot searches there.  Where the range is
// longer than the buffer (a long run of gaussians that cover no tile between
// two that do), the block's slots search [g_lo, g_hi] in global memory: the
// same integers either way.  A thread takes two neighbouring slots and
// writes keys and owners as 16-byte stores.
//
// Plain version: splat_tpu_torch/render/expand.py::expand_pair_keys_plain.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define HALF (THREADS / 2)
#define SLOTS_PER_BLOCK 1024
#define STAGE_CAP 2048  // first_slot entries a block keeps in shared memory
#define FULL 0xffffffffu

// First g in [lo, hi) with first_slot[g] > k, else hi (upper bound).
template <typename T, typename K>
__device__ __forceinline__ int64_t upper_bound(const T* __restrict__ v,
                                               int64_t lo, int64_t hi, K k) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (v[mid] <= k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct ExpandArgs {
  const int64_t* first_slot;
  const int32_t* tx0;
  const int32_t* ty0;
  const int32_t* span_w;
  const int32_t* depth_bits;
  const float4* cull;  // (cx, cy, lam, thresh) per gaussian, or null
  int64_t n;
  int32_t ntx, tile_w, tile_h;
};

// The cull's test (plain version: render/expand.py::cull_dead), in
// explicitly rounded operations in the plain version's order: the tile's
// pixels are [tx * tile_w, tx * tile_w + tile_w - 1] (and so in y), and
// the offset to the nearest one is rounded as the raster kernel rounds
// px - cx (a NaN offset keeps the pair: fmaxf drops it, thresh is +inf).
__device__ __forceinline__ bool cull_dead(const ExpandArgs& a, int64_t g,
                                          int64_t tx, int64_t ty) {
  const float4 c = a.cull[g];
  const float xa = (float)(tx * a.tile_w), ya = (float)(ty * a.tile_h);
  const float xb = __fadd_rn(xa, (float)(a.tile_w - 1));
  const float yb = __fadd_rn(ya, (float)(a.tile_h - 1));
  const float ddx =
      fmaxf(fmaxf(__fsub_rn(xa, c.x), __fsub_rn(c.x, xb)), 0.f);
  const float ddy =
      fmaxf(fmaxf(__fsub_rn(ya, c.y), __fsub_rn(c.y, yb)), 0.f);
  const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
  return __fmul_rn(d2, c.z) > c.w;
}

template <bool CULL>
__device__ __forceinline__ int64_t key_of(const ExpandArgs& a, int64_t g,
                                          int64_t r, int32_t num_tiles,
                                          int64_t* own) {
  const int64_t sw = a.span_w[g];
  const int64_t dy = r / sw;
  const int64_t dx = r - dy * sw;
  const int64_t tx = a.tx0[g] + dx, ty = a.ty0[g] + dy;
  if constexpr (CULL) {
    if (cull_dead(a, g, tx, ty)) {
      *own = 0;
      return (int64_t)num_tiles << 32;
    }
  }
  *own = g;
  return ((ty * a.ntx + tx) << 32) | (int64_t)(uint32_t)a.depth_bits[g];
}

template <bool CULL>
__global__ void __launch_bounds__(THREADS) expand_pairs_kernel(
    ExpandArgs a, const int64_t* __restrict__ total, int64_t k_cap,
    int32_t num_tiles, int64_t* __restrict__ keys,
    int64_t* __restrict__ owner) {
  __shared__ int32_t rel[STAGE_CAP];  // first_slot[g_lo + i] - k0
  __shared__ int cnt[THREADS / 32];
  __shared__ int64_t bound[2];        // upper bounds of the first, last slot

  const int64_t k0 = (int64_t)blockIdx.x * SLOTS_PER_BLOCK;
  const int64_t t = *total;
  const int64_t filled = t < k_cap ? t : k_cap;
  const int64_t kend = min(k0 + SLOTS_PER_BLOCK, k_cap);
  const int64_t kfill = min(kend, filled);  // slots [k0, kfill) have owners

  int64_t g_lo = 0;
  int nstage = 0;  // 0: the slots search global memory
  if (kfill > k0) {  // uniform over the block
    // half 0 searches the first slot's upper bound, half 1 the last's
    const int half = threadIdx.x / HALF, i = threadIdx.x % HALF;
    const int64_t k = half ? kfill - 1 : k0;
    int64_t lo = 0, hi = a.n;
    for (;;) {
      // probe i looks at lo + (i + 1) * step - 1; the probes at or below k
      // are a prefix, and c counts them
      const int64_t step = (hi - lo + HALF - 1) / HALF;
      const int64_t q = lo + (i + 1) * step - 1;
      const bool below = hi > lo && q < hi && a.first_slot[q] <= k;
      const unsigned b = __ballot_sync(FULL, below);
      if ((threadIdx.x & 31) == 0) cnt[threadIdx.x >> 5] = __popc(b);
      __syncthreads();
      int c = 0;
      for (int wq = 0; wq < HALF / 32; ++wq) c += cnt[half * (HALF / 32) + wq];
      if (hi > lo) {
        hi = min(hi, lo + (c + 1) * step - 1);
        lo = min(lo + c * step, hi);
      }
      if (!__syncthreads_or(hi > lo)) break;  // also: cnt may be rewritten
    }
    if (i == 0) bound[half] = lo;
    __syncthreads();
    g_lo = bound[0] - 1;  // first_slot[0] == 0 <= k0: bound[0] >= 1
    const int64_t len = bound[1] - g_lo;  // owners g_lo .. bound[1] - 1
    if (len <= STAGE_CAP) {
      nstage = (int)len;
      for (int j = threadIdx.x; j < nstage; j += THREADS)
        rel[j] = (int32_t)(a.first_slot[g_lo + j] - k0);
      __syncthreads();
    }
  }

  // a thread takes two neighbouring slots per pass: 16-byte stores
  for (int64_t k = k0 + 2 * threadIdx.x; k < kend; k += 2 * THREADS) {
    int64_t key[2], own[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t kk = k + j;
      if (kk >= kfill) {
        key[j] = (int64_t)num_tiles << 32;
        own[j] = 0;
        continue;
      }
      int64_t g, first;
      if (nstage) {
        const int q = (int)upper_bound(rel, 0, nstage, (int32_t)(kk - k0)) - 1;
        g = g_lo + q;
        first = k0 + rel[q];
      } else {
        g = upper_bound(a.first_slot, g_lo, bound[1], kk) - 1;
        first = a.first_slot[g];
      }
      key[j] = key_of<CULL>(a, g, kk - first, num_tiles, &own[j]);
    }
    if (k + 1 < kend) {  // k is even and the arrays are 16-byte aligned
      *reinterpret_cast<longlong2*>(keys + k) = make_longlong2(key[0], key[1]);
      *reinterpret_cast<longlong2*>(owner + k) =
          make_longlong2(own[0], own[1]);
    } else {
      keys[k] = key[0];
      owner[k] = own[0];
    }
  }
}

// cull: (n, 4) f32 rows of render/binning.py::cull_rows, or null (no cull).
extern "C" int splat_expand_pairs(const void* first_slot, const void* tx0,
                                  const void* ty0, const void* span_w,
                                  const void* depth_bits, const void* total,
                                  const void* cull, int64_t n, int64_t k_cap,
                                  int ntx, int num_tiles, int tile_w,
                                  int tile_h, void* keys, void* owner,
                                  void* stream) {
  // the paired stores need 16-byte aligned outputs (torch.empty's are), and
  // the cull table is read as float4
  if (((uintptr_t)keys | (uintptr_t)owner | (uintptr_t)cull) & 15)
    return (int)cudaErrorMisalignedAddress;
  const ExpandArgs a = {(const int64_t*)first_slot, (const int32_t*)tx0,
                        (const int32_t*)ty0, (const int32_t*)span_w,
                        (const int32_t*)depth_bits, (const float4*)cull,
                        n, ntx, tile_w, tile_h};
  const int64_t blocks = (k_cap + SLOTS_PER_BLOCK - 1) / SLOTS_PER_BLOCK;
  if (cull) {
    expand_pairs_kernel<true>
        <<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            a, (const int64_t*)total, k_cap, num_tiles, (int64_t*)keys,
            (int64_t*)owner);
  } else {
    expand_pairs_kernel<false>
        <<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            a, (const int64_t*)total, k_cap, num_tiles, (int64_t*)keys,
            (int64_t*)owner);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* splat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
