// Projection front end: every gaussian's binning inputs for one frame, in
// one pass over the packed (59, N) scene.
//
// Replaces no Pallas kernel.  It is the XLA fusion of
// splat_tpu/ops/projection.py::project_gaussians and of the per-gaussian
// prep of splat_tpu/render/binning.py (the quantized radii, the tile spans
// and pair counts, the depth key, the feature rows and the cull rows), which
// the port ran as some hundred PyTorch elementwise launches, each reading and
// writing whole (N,) arrays.  Per gaussian it writes:
//   rbits       the radii ceil-quantized to 1/8 px in two 15-bit fields,
//               visibility in bit 30 (binning.py::quantize_radius_bits);
//   tx0, ty0, span_w, counts   the tile rectangle and its pair count
//               (binning.py::tile_spans);
//   depth_bits  the bits of the f32 view depth;
//   feats       the 11 rows of binning.py::FEATURE_ROWS, feature major: the
//               centre, the prescaled conic, the colour clamped to [0, 1],
//               the opacity and the squared DECODED quantized radii;
//   cull        with cull_pairs, the (N, 4) rows of binning.py::cull_rows;
// and adds the visible count and the pair count into sums[0], sums[1].  The
// count-only variant reads rows 0-10 (no SH) and writes only the two sums:
// the pair demand of a view (pair_stats, fit's demand pass).
//
// What bounds it on the card: bytes.  236 B in a gaussian (59 f32 rows) and
// about 68 B out (six int32 fields and 11 f32 rows; 16 B more with the cull):
// 0.27 ms at 3M gaussians on 3.35 TB/s.  The arithmetic, ~400 FP32 operations
// and a few SFU ones a gaussian, is far below the card's rate.
//
// What the design does about it: one thread a gaussian, in a grid-stride
// loop.  Its 59 loads are one coalesced row read each (neighbouring threads,
// neighbouring gaussians), every intermediate stays in registers, and each
// output row is one coalesced store (the cull row one 16-byte store): no
// N-length intermediate touches device memory.  A block adds its visible and
// pair counts with one atomic each.
//
// Rounding: the plain version (render/front.py::project_front_plain) is a
// chain of PyTorch ops, each rounded to f32 once.  Here every operation is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn)
// in the plain version's order, so nothing is contracted into an FMA;
// logf and hypotf are the functions PyTorch's CUDA kernels call; clamp,
// minimum and the casts treat NaN as PyTorch's do; and a division by a
// Python number is a multiplication by its reciprocal, taken in double and
// rounded to f32 (the wrapper passes it), as PyTorch's CUDA true division
// computes it.  Every output then equals the plain version on the card bit
// for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define BLOCKS_PER_SM 8
#define R15_MAX 32767
// the camera record (camera.py, Camera.record): view rows 0-2, then
// fx, fy, cx, cy, the SH eye and znear
#define CAM_FLOATS 20

// SH constants as PyTorch uses a Python float: the double, rounded to f32
#define SH_C0 ((float)0.28209479177387814)
#define SH_C1 ((float)0.4886025119029199)
#define SH_C2_0 ((float)1.0925484305920792)
#define SH_C2_1 ((float)-1.0925484305920792)
#define SH_C2_2 ((float)0.31539156525252005)
#define SH_C2_3 ((float)-1.0925484305920792)
#define SH_C2_4 ((float)0.5462742152960396)
#define SH_C3_0 ((float)-0.5900435899266435)
#define SH_C3_1 ((float)2.890611442640554)
#define SH_C3_2 ((float)-0.4570457994644658)
#define SH_C3_3 ((float)0.3731763325901154)
#define SH_C3_4 ((float)-0.4570457994644658)
#define SH_C3_5 ((float)1.445305721320277)
#define SH_C3_6 ((float)-0.5900435899266435)
// binning.py's cull margins and ops/*.py's clamps, as f32
#define CULL_TRACE_MARGIN ((float)1e-5)
#define CULL_LOG_MARGIN ((float)1e-4)
#define CULL_MAX_CENTRE ((float)1e6)
#define TINY ((float)1e-12)

#define DEV __device__ __forceinline__
DEV float mul(float a, float b) { return __fmul_rn(a, b); }
DEV float add(float a, float b) { return __fadd_rn(a, b); }
DEV float sub(float a, float b) { return __fsub_rn(a, b); }
DEV float dv(float a, float b) { return __fdiv_rn(a, b); }
DEV float sqrt_rn(float a) { return __fsqrt_rn(a); }

// torch.clamp / clamp(min=) / minimum on the card: a NaN passes through
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

struct FrontArgs {
  const float* scene;  // (59, >= n) rows, row r at scene + r * row_stride
  int64_t row_stride;
  int64_t n;
  const float* cam;    // CAM_FLOATS
  float lowpass, sigma_cutoff, alpha_min, img_w, img_h;
  // 1 / alpha_min, 1 / tile_w, 1 / tile_h: the divisions by Python numbers
  float inv_alpha_min, inv_tile_w, inv_tile_h;
  int tight_radius, cov3d_transpose;
  int sh_degree;       // < 0: no colour (render_mode "depth")
  int ntx, nty;
  int32_t* rbits;
  int32_t* tx0;
  int32_t* ty0;
  int32_t* span_w;
  int32_t* counts;
  int32_t* depth_bits;
  float* feats;        // (11, n): binning.py::FEATURE_ROWS
  float4* cull;        // (n, 4), or null
  unsigned long long* sums;  // visible, pairs
};

// binning.py::quantize_radius_bits' 15-bit field
__device__ __forceinline__ int32_t q15(float r) {
  const float v = clamp(ceilf(mul(r, 8.f)), 0.f, (float)R15_MAX);
  return isnan(v) ? 0 : (int32_t)v;
}

// binning.py::decode_radius_bits' radius: a saturated field is +inf
__device__ __forceinline__ float decode15(int32_t q) {
  return q == R15_MAX ? INFINITY : mul((float)q, 0.125f);
}

// binning.py::tile_spans' edge: floor(v / tp) clamped to the grid (v / tp
// on the card is v times the reciprocal), 0 where invisible
__device__ __forceinline__ int32_t edge(float v, float inv_tp, int nt,
                                        bool vis) {
  const float f = clamp(floorf(mul(v, inv_tp)), 0.f, (float)(nt - 1));
  return vis ? (int32_t)f : 0;
}

// ops/projection.py's quad(p, r) = p^T Sigma r over the packed covariance
__device__ __forceinline__ float quad(const float c[6], const float p[3],
                                      const float r[3]) {
  float s = mul(c[0], mul(p[0], r[0]));
  s = add(s, mul(c[3], mul(p[1], r[1])));
  s = add(s, mul(c[5], mul(p[2], r[2])));
  s = add(s, mul(c[1], add(mul(p[0], r[1]), mul(p[1], r[0]))));
  s = add(s, mul(c[2], add(mul(p[0], r[2]), mul(p[2], r[0]))));
  s = add(s, mul(c[4], add(mul(p[1], r[2]), mul(p[2], r[1]))));
  return s;
}

// ops/sh.py::eval_sh_cols for one gaussian: rows 11 + 3k + c of the scene
__device__ __forceinline__ void eval_sh(const FrontArgs& a, int64_t g,
                                        float x, float y, float z,
                                        float out[3]) {
  const float* sh = a.scene + 11 * a.row_stride + g;
  const int64_t rs = a.row_stride;
#define SH(k, c) __ldg(sh + (3 * (k) + (c)) * rs)
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = mul(SH_C0, SH(0, c));
  if (a.sh_degree >= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c] = sub(out[c], mul(mul(SH_C1, y), SH(1, c)));
      out[c] = add(out[c], mul(mul(SH_C1, z), SH(2, c)));
      out[c] = sub(out[c], mul(mul(SH_C1, x), SH(3, c)));
    }
  }
  if (a.sh_degree >= 2) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    const float b2[5] = {mul(SH_C2_0, xy), mul(SH_C2_1, yz),
                         mul(SH_C2_2, sub(sub(mul(2.f, zz), xx), yy)),
                         mul(SH_C2_3, xz), mul(SH_C2_4, sub(xx, yy))};
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[c] = add(out[c], mul(b2[k], SH(4 + k, c)));
    if (a.sh_degree >= 3) {
      const float b3[7] = {
          mul(mul(SH_C3_0, y), sub(mul(3.f, xx), yy)),
          mul(mul(SH_C3_1, xy), z),
          mul(mul(SH_C3_2, y), sub(sub(mul(4.f, zz), xx), yy)),
          mul(mul(SH_C3_3, z),
              sub(sub(mul(2.f, zz), mul(3.f, xx)), mul(3.f, yy))),
          mul(mul(SH_C3_4, x), sub(sub(mul(4.f, zz), xx), yy)),
          mul(mul(SH_C3_5, z), sub(xx, yy)),
          mul(mul(SH_C3_6, x), sub(xx, mul(3.f, yy)))};
#pragma unroll
      for (int k = 0; k < 7; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          out[c] = add(out[c], mul(b3[k], SH(9 + k, c)));
    }
  }
#undef SH
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = add(out[c], 0.5f);
}

// What every thread derives once from the camera and the config.
struct Frame {
  float cam[CAM_FLOATS];
  float sig2;
};

__device__ __forceinline__ Frame frame_of(const FrontArgs& a) {
  Frame f;
#pragma unroll
  for (int i = 0; i < CAM_FLOATS; ++i) f.cam[i] = __ldg(a.cam + i);
  f.sig2 = mul(a.sigma_cutoff, a.sigma_cutoff);
  return f;
}

// Gaussian g: its pair count (0 where invisible) and visibility; without
// COUNT_ONLY it also writes every output at g.
template <bool COUNT_ONLY>
__device__ __forceinline__ int32_t project_one(const FrontArgs& a,
                                               const Frame& fr, int64_t g,
                                               bool* visible) {
  const float* cam = fr.cam;
  const float u[3] = {cam[0], cam[1], cam[2]};
  const float v[3] = {cam[4], cam[5], cam[6]};
  const float fx = cam[12], fy = cam[13], cx0 = cam[14], cy0 = cam[15];
  const int64_t rs = a.row_stride;
  const float* col = a.scene + g;
  const float mx = __ldg(col), my = __ldg(col + rs), mz = __ldg(col + 2 * rs);
  float qw = __ldg(col + 3 * rs), qx = __ldg(col + 4 * rs);
  float qy = __ldg(col + 5 * rs), qz = __ldg(col + 6 * rs);
  const float sx = __ldg(col + 7 * rs), sy = __ldg(col + 8 * rs);
  const float sz = __ldg(col + 9 * rs), op = __ldg(col + 10 * rs);
  if (a.cov3d_transpose) {  // R(q*) = R(q)^T
    qx = -qx;
    qy = -qy;
    qz = -qz;
  }
  // ops/transforms.py::compute_cov6_cols
  const float qn =
      add(add(add(mul(qw, qw), mul(qx, qx)), mul(qy, qy)), mul(qz, qz));
  const float inv = dv(1.f, clamp_min(sqrt_rn(qn), TINY));
  const float w = mul(qw, inv), x = mul(qx, inv), y = mul(qy, inv),
              z = mul(qz, inv);
  const float m00 = mul(sub(1.f, mul(2.f, add(mul(y, y), mul(z, z)))), sx);
  const float m01 = mul(mul(2.f, sub(mul(x, y), mul(w, z))), sy);
  const float m02 = mul(mul(2.f, add(mul(x, z), mul(w, y))), sz);
  const float m10 = mul(mul(2.f, add(mul(x, y), mul(w, z))), sx);
  const float m11 = mul(sub(1.f, mul(2.f, add(mul(x, x), mul(z, z)))), sy);
  const float m12 = mul(mul(2.f, sub(mul(y, z), mul(w, x))), sz);
  const float m20 = mul(mul(2.f, sub(mul(x, z), mul(w, y))), sx);
  const float m21 = mul(mul(2.f, add(mul(y, z), mul(w, x))), sy);
  const float m22 = mul(sub(1.f, mul(2.f, add(mul(x, x), mul(y, y)))), sz);
  // (xx, xy, xz, yy, yz, zz)
  const float cov[6] = {add(add(mul(m00, m00), mul(m01, m01)), mul(m02, m02)),
                        add(add(mul(m00, m10), mul(m01, m11)), mul(m02, m12)),
                        add(add(mul(m00, m20), mul(m01, m21)), mul(m02, m22)),
                        add(add(mul(m10, m10), mul(m11, m11)), mul(m12, m12)),
                        add(add(mul(m10, m20), mul(m11, m21)), mul(m12, m22)),
                        add(add(mul(m20, m20), mul(m21, m21)), mul(m22, m22))};

  // ops/projection.py::project_gaussians
  const float px =
      add(add(add(mul(cam[0], mx), mul(cam[1], my)), mul(cam[2], mz)), cam[3]);
  const float py =
      add(add(add(mul(cam[4], mx), mul(cam[5], my)), mul(cam[6], mz)), cam[7]);
  const float pz = add(add(add(mul(cam[8], mx), mul(cam[9], my)),
                           mul(cam[10], mz)),
                       cam[11]);
  const float spx = dv(fx, pz), spy = dv(fy, pz);
  const float ca = add(mul(mul(spx, spx), quad(cov, u, u)), a.lowpass);
  const float cb = mul(mul(spx, spy), quad(cov, u, v));
  const float cc = add(mul(mul(spy, spy), quad(cov, v, v)), a.lowpass);
  const float det = sub(mul(ca, cc), mul(cb, cb));
  float cut2 = fr.sig2;
  if (a.tight_radius) {
    const float qmax =
        mul(2.f, logf(clamp_min(mul(op, a.inv_alpha_min), TINY)));
    cut2 = minimum(cut2, clamp_min(qmax, 0.f));
  }
  const float rx = sqrt_rn(mul(cut2, clamp_min(ca, 0.f)));
  const float ry = sqrt_rn(mul(cut2, clamp_min(cc, 0.f)));
  const float clip_w = -pz;
  const float cx = add(cx0, mul(fx, dv(px, clip_w)));
  const float cy = sub(cy0, mul(fy, dv(py, clip_w)));
  const float depth = -pz;
  const bool vis = depth > cam[19] && det > 0.f && add(cx, rx) > 0.f &&
                   sub(cx, rx) < a.img_w && add(cy, ry) > 0.f &&
                   sub(cy, ry) < a.img_h && isfinite(cx) && isfinite(cy) &&
                   op >= a.alpha_min;

  // binning.py::quantize_radius_bits, tile_spans
  const int32_t rxq = q15(rx), ryq = q15(ry);
  const float rxd = decode15(rxq), ryd = decode15(ryq);
  const int32_t tx0 = edge(sub(cx, rxd), a.inv_tile_w, a.ntx, vis);
  const int32_t tx1 = edge(add(cx, rxd), a.inv_tile_w, a.ntx, vis);
  const int32_t ty0 = edge(sub(cy, ryd), a.inv_tile_h, a.nty, vis);
  const int32_t ty1 = edge(add(cy, ryd), a.inv_tile_h, a.nty, vis);
  const int32_t sw = tx1 - tx0 + 1;
  const int32_t count = vis ? sw * (ty1 - ty0 + 1) : 0;
  *visible = vis;
  if constexpr (COUNT_ONLY) return count;

  a.rbits[g] = rxq | (ryq << 15) | ((int32_t)vis << 30);
  a.tx0[g] = tx0;
  a.ty0[g] = ty0;
  a.span_w[g] = sw;
  a.counts[g] = count;
  a.depth_bits[g] = __float_as_int(depth);

  // the conic (c, -b, a) / det
  const float inv_det = dv(1.f, det > 0.f ? det : 1.f);
  const float ka = mul(cc, inv_det), kb = mul(-cb, inv_det),
              kc = mul(ca, inv_det);
  float rgb[3] = {0.f, 0.f, 0.f};
  if (a.sh_degree >= 0) {
    const float rdx = sub(mx, cam[16]), rdy = sub(my, cam[17]),
                rdz = sub(mz, cam[18]);
    const float rinv = dv(
        1.f,
        clamp_min(sqrt_rn(add(add(mul(rdx, rdx), mul(rdy, rdy)),
                              mul(rdz, rdz))),
                  TINY));
    eval_sh(a, g, mul(rdx, rinv), mul(rdy, rinv), mul(rdz, rinv), rgb);
  }
  float* f = a.feats + g;
  const int64_t n = a.n;
  f[0] = cx;
  f[n] = cy;
  f[2 * n] = mul(-0.5f, ka);
  f[3 * n] = -kb;
  f[4 * n] = mul(-0.5f, kc);
  f[5 * n] = clamp(rgb[0], 0.f, 1.f);
  f[6 * n] = clamp(rgb[1], 0.f, 1.f);
  f[7 * n] = clamp(rgb[2], 0.f, 1.f);
  f[8 * n] = op;
  f[9 * n] = mul(rxd, rxd);
  f[10 * n] = mul(ryd, ryd);

  if (a.cull) {  // binning.py::cull_rows
    const float tr = add(ka, kc);
    const float lam =
        sub(dv(sub(mul(ka, kc), mul(kb, kb)),
               add(mul(0.5f, tr), hypotf(mul(0.5f, sub(ka, kc)), kb))),
            mul(CULL_TRACE_MARGIN, tr));
    const float thresh =
        add(mul(2.f, logf(mul(op, a.inv_alpha_min))), CULL_LOG_MARGIN);
    const bool ok = vis && isfinite(lam) && isfinite(thresh) && lam > 0.f &&
                    fabsf(cx) <= CULL_MAX_CENTRE &&
                    fabsf(cy) <= CULL_MAX_CENTRE;
    a.cull[g] = make_float4(cx, cy, lam, ok ? thresh : INFINITY);
  }
  return count;
}

template <bool COUNT_ONLY>
__global__ void __launch_bounds__(THREADS) project_front_kernel(FrontArgs a) {
  __shared__ unsigned long long part[THREADS / 32][2];
  const Frame fr = frame_of(a);
  unsigned long long nvis = 0, npairs = 0;
  for (int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x; g < a.n;
       g += (int64_t)gridDim.x * THREADS) {
    bool vis;
    npairs += project_one<COUNT_ONLY>(a, fr, g, &vis);
    nvis += vis;
  }

  // the block's counts: one atomic each
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    nvis += __shfl_down_sync(0xffffffffu, nvis, off);
    npairs += __shfl_down_sync(0xffffffffu, npairs, off);
  }
  if ((threadIdx.x & 31) == 0) {
    part[threadIdx.x >> 5][0] = nvis;
    part[threadIdx.x >> 5][1] = npairs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sv = 0, sp = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      sv += part[i][0];
      sp += part[i][1];
    }
    atomicAdd(a.sums, sv);
    atomicAdd(a.sums + 1, sp);
  }
}

// scene: the (59, >= n) f32 rows, row_stride elements apart, each row dense.
// Outputs rbits .. feats are null with count_only; cull is null without the
// cull.  sums (2 int64) is zeroed here, then counts the visible gaussians
// and the pairs.
extern "C" int splat_project_front(
    const void* scene, int64_t row_stride, int64_t n, const void* cam,
    float lowpass, float sigma_cutoff, float alpha_min, float inv_alpha_min,
    float inv_tile_w, float inv_tile_h, int tight_radius, int cov3d_transpose,
    int sh_degree, int img_w, int img_h, int ntx, int nty, int count_only,
    void* rbits, void* tx0, void* ty0, void* span_w, void* counts,
    void* depth_bits, void* feats, void* cull, void* sums, void* stream) {
  if ((uintptr_t)cull & 15) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(sums, 0, 2 * sizeof(int64_t), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const FrontArgs a = {
      (const float*)scene, row_stride, n, (const float*)cam, lowpass,
      sigma_cutoff, alpha_min, (float)img_w, (float)img_h, inv_alpha_min,
      inv_tile_w, inv_tile_h, tight_radius, cov3d_transpose, sh_degree, ntx,
      nty, (int32_t*)rbits, (int32_t*)tx0, (int32_t*)ty0, (int32_t*)span_w,
      (int32_t*)counts, (int32_t*)depth_bits, (float*)feats, (float4*)cull,
      (unsigned long long*)sums};
  const int64_t need = (n + THREADS - 1) / THREADS;
  const int64_t most = (int64_t)sms * BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(need < most ? need : most);
  if (count_only) {
    project_front_kernel<true><<<blocks, THREADS, 0, s>>>(a);
  } else {
    project_front_kernel<false><<<blocks, THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
