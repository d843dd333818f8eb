// Native 3DGS PLY loader: single-pass, multithreaded parse + activation.
//
// The host-side twin of the reference's ply-rs loader
// (reference: src/gaussians.rs:246-283, :375-405) built for multi-GB
// pretrained scenes: instead of NumPy's one-strided-pass-per-field record
// extraction (60+ passes over the payload), each worker thread walks its
// row range once, applying the activation pipeline in registers:
//   scales   <- exp(scale_i)
//   opacity  <- sigmoid(opacity)
//   quat     <- normalize(rot_0..3), scalar-first
//   sh       <- f_dc into coeff 0; f_rest channel-major -> coeff-major
// and writing straight into the Python-owned SoA float32 buffers.
//
// Only the standard 3DGS schema subset is handled natively
// (binary_little_endian, all-float32 vertex properties); anything else is
// rejected and the caller falls back to the NumPy path.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this toolchain).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Layout {
  int64_t num_vertices = 0;
  int stride_floats = 0;        // floats per vertex record
  // per-field float offsets within a record; -1 = absent
  int xyz[3] = {-1, -1, -1};
  int scale[3] = {-1, -1, -1};
  int rot[4] = {-1, -1, -1, -1};
  int opacity = -1;
  int f_dc[3] = {-1, -1, -1};
  std::vector<int> f_rest;      // ordered by index
  int64_t payload_offset = 0;   // bytes from file start
  std::string error;
};

bool parse_header(FILE* f, Layout* lay) {
  char line[512];
  if (!std::fgets(line, sizeof line, f) || std::strncmp(line, "ply", 3)) {
    lay->error = "not a PLY file";
    return false;
  }
  bool in_vertex = false;
  bool fmt_ok = false;
  std::vector<std::pair<std::string, int>> rest_tmp;
  int offset = 0;
  while (std::fgets(line, sizeof line, f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.rfind("comment", 0) == 0) continue;
    if (s.rfind("format", 0) == 0) {
      fmt_ok = s.find("binary_little_endian") != std::string::npos;
      if (!fmt_ok) { lay->error = "unsupported format (need binary LE)"; return false; }
    } else if (s.rfind("element", 0) == 0) {
      char name[128];
      long long cnt = 0;
      if (std::sscanf(s.c_str(), "element %127s %lld", name, &cnt) == 2) {
        if (std::strcmp(name, "vertex") == 0) {
          in_vertex = true;
          lay->num_vertices = cnt;
        } else if (in_vertex) {
          lay->error = "elements after vertex not supported";
          return false;
        }
      }
    } else if (s.rfind("property", 0) == 0) {
      if (!in_vertex) { lay->error = "property outside vertex element"; return false; }
      char type[64], pname[128];
      if (std::sscanf(s.c_str(), "property %63s %127s", type, pname) != 2) {
        lay->error = "bad property line";
        return false;
      }
      if (std::strcmp(type, "float") != 0 && std::strcmp(type, "float32") != 0) {
        lay->error = std::string("non-float property: ") + pname;
        return false;
      }
      std::string p(pname);
      if (p == "x") lay->xyz[0] = offset;
      else if (p == "y") lay->xyz[1] = offset;
      else if (p == "z") lay->xyz[2] = offset;
      else if (p == "opacity") lay->opacity = offset;
      else if (p.rfind("scale_", 0) == 0) {
        int i = std::atoi(p.c_str() + 6);
        if (0 <= i && i < 3) lay->scale[i] = offset;
      } else if (p.rfind("rot_", 0) == 0) {
        int i = std::atoi(p.c_str() + 4);
        if (0 <= i && i < 4) lay->rot[i] = offset;
      } else if (p.rfind("f_dc_", 0) == 0) {
        int i = std::atoi(p.c_str() + 5);
        if (0 <= i && i < 3) lay->f_dc[i] = offset;
      } else if (p.rfind("f_rest_", 0) == 0) {
        rest_tmp.emplace_back(p, offset);
      }
      offset += 1;
    } else if (s == "end_header") {
      lay->stride_floats = offset;
      lay->payload_offset = std::ftell(f);
      // order f_rest by numeric suffix
      lay->f_rest.assign(rest_tmp.size(), -1);
      for (auto& kv : rest_tmp) {
        int idx = std::atoi(kv.first.c_str() + 7);
        if (idx < 0 || idx >= (int)rest_tmp.size()) {
          lay->error = "non-contiguous f_rest indices";
          return false;
        }
        lay->f_rest[idx] = kv.second;
      }
      // Duplicate f_rest_N properties leave -1 holes (the duplicate evicted
      // another index under the size==count assumption); reading rec[-1]
      // would be out of bounds, so reject the malformed file instead.
      for (int off : lay->f_rest) {
        if (off < 0) {
          lay->error = "duplicate f_rest indices";
          return false;
        }
      }
      if (!fmt_ok) { lay->error = "missing format line"; return false; }
      if (lay->xyz[0] < 0 || lay->xyz[1] < 0 || lay->xyz[2] < 0 ||
          lay->opacity < 0) {
        lay->error = "missing required x/y/z/opacity";
        return false;
      }
      if (lay->f_rest.size() % 3) {
        lay->error = "f_rest count not divisible by 3";
        return false;
      }
      return true;
    }
  }
  lay->error = "unexpected EOF in header";
  return false;
}

thread_local std::string g_error;

}  // namespace

extern "C" {

// Parses the header. Returns N (>=0) on success, -1 on failure
// (splat_ply_last_error() has the message). sh_rest_out gets the number of
// f_rest coefficients per channel (e.g. 15 for degree 3).
long long splat_ply_query(const char* path, int* sh_rest_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { g_error = "cannot open file"; return -1; }
  Layout lay;
  bool ok = parse_header(f, &lay);
  std::fclose(f);
  if (!ok) { g_error = lay.error; return -1; }
  *sh_rest_out = (int)(lay.f_rest.size() / 3);
  return lay.num_vertices;
}

const char* splat_ply_last_error() { return g_error.c_str(); }

// Reads + activates into caller-allocated float32 buffers:
//   means   (N,3)   raw positions (centering is done by the caller so the
//                   mean reduction stays a single pass in NumPy)
//   quats   (N,4)   normalized, scalar-first
//   scales  (N,3)   exp-activated
//   opac    (N,)    sigmoid-activated
//   sh      (N, 1+sh_rest, 3)  DC first, f_rest transposed channel-major ->
//                   coefficient-major (reference notes/util_gau.py:82-84)
// Returns 0 on success, -1 on failure.
int splat_ply_read(const char* path, float* means, float* quats,
                   float* scales, float* opac, float* sh, int num_threads) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { g_error = "cannot open file"; return -1; }
  Layout lay;
  if (!parse_header(f, &lay)) {
    std::fclose(f);
    g_error = lay.error;
    return -1;
  }
  const int64_t n = lay.num_vertices;
  const int stride = lay.stride_floats;
  const int rest_per_ch = (int)(lay.f_rest.size() / 3);
  const int sh_coeffs = 1 + rest_per_ch;

  std::vector<float> payload((size_t)n * stride);
  size_t got = std::fread(payload.data(), sizeof(float) * stride, (size_t)n, f);
  std::fclose(f);
  if (got != (size_t)n) {
    g_error = "payload truncated";
    return -1;
  }

  if (num_threads <= 0) {
    num_threads = (int)std::thread::hardware_concurrency();
    if (num_threads <= 0) num_threads = 4;
  }
  if ((int64_t)num_threads > n) num_threads = n > 0 ? (int)n : 1;

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* rec = payload.data() + (size_t)i * stride;
      for (int k = 0; k < 3; ++k) means[i * 3 + k] = rec[lay.xyz[k]];
      for (int k = 0; k < 3; ++k) {
        scales[i * 3 + k] =
            lay.scale[k] >= 0 ? std::exp(rec[lay.scale[k]]) : 1.0f;
      }
      opac[i] = 1.0f / (1.0f + std::exp(-rec[lay.opacity]));
      float q[4];
      for (int k = 0; k < 4; ++k) {
        q[k] = lay.rot[k] >= 0 ? rec[lay.rot[k]] : (k == 0 ? 1.0f : 0.0f);
      }
      float norm = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                             q[3] * q[3]);
      if (norm < 1e-12f) norm = 1e-12f;
      for (int k = 0; k < 4; ++k) quats[i * 4 + k] = q[k] / norm;
      float* shi = sh + (size_t)i * sh_coeffs * 3;
      for (int c = 0; c < 3; ++c) {
        shi[c] = lay.f_dc[c] >= 0 ? rec[lay.f_dc[c]] : 0.0f;
      }
      // file order: all rest_per_ch R coeffs, then G, then B
      for (int c = 0; c < 3; ++c) {
        for (int k = 0; k < rest_per_ch; ++k) {
          shi[(1 + k) * 3 + c] = rec[lay.f_rest[c * rest_per_ch + k]];
        }
      }
    }
  };

  std::vector<std::thread> threads;
  int64_t per = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
