// QSGD s-level stochastic quantization (Alistarh et al.) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/qsgd/qsgd.py::qsgd_compress
// and computes what it computes, elementwise over g, u [R, C] (fp32; u
// uniform in [0, 1), drawn outside):
//
//   p     = |g| / max(norm, 1e-30) * s
//   level = clip(floor(p) + (u < p - floor(p)), 0, s)
//   q     = sign(g) * level                             int8 [R, C]
//
// with sign(0) = 0 and s <= 127.  norm (the l2 norm, a reduction taken
// outside as in JAX) is a device vector with one entry per segment of
// `rows_per_segment` rows: one for the compressor's leaf, one per worker
// for the segment codec.
//
// Rounding: p is __fmul_rn(__fdiv_rn(|g|, max(norm, 1e-30)), s), divide
// then multiply as JAX evaluates it, never contracted; so the levels equal
// the plain version's bit for bit given the same u and norm.
//
// What bounds it on this card: bytes.  Per element it reads g and u and
// writes one int8 (9 B) for about eight operations.  What the design does
// about it: one pass, a grid-stride loop reading 16-byte vectors (float4)
// and writing 4-byte vectors when C % 4 == 0 and the pointers are aligned,
// else one element at a time.
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 32;   // grid-stride blocks per SM

struct QsgdParams {
  const float* g;
  const float* u;
  const float* norm;       // [segments]
  int8_t* out;
  long long n;             // R * C
  int C;
  int rows_per_segment;
  float s;                 // levels
};

__device__ __forceinline__ int8_t qsgd_one(float g, float u, float norm,
                                           float s) {
  const float p = __fmul_rn(__fdiv_rn(fabsf(g), fmaxf(norm, 1e-30f)), s);
  const float lo = floorf(p);
  float level = __fadd_rn(lo, u < __fsub_rn(p, lo) ? 1.f : 0.f);
  level = fminf(fmaxf(level, 0.f), s);
  const int sign = (g > 0.f) - (g < 0.f);
  return static_cast<int8_t>(sign * static_cast<int>(level));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) qsgd_kernel(QsgdParams p) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads * VEC;
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * VEC;
       i < p.n; i += step) {
    const float norm = p.norm[(i / p.C) / p.rows_per_segment];
    if constexpr (VEC == 4) {
      const float4 g = *reinterpret_cast<const float4*>(p.g + i);
      const float4 u = *reinterpret_cast<const float4*>(p.u + i);
      *reinterpret_cast<char4*>(p.out + i) = make_char4(
          qsgd_one(g.x, u.x, norm, p.s), qsgd_one(g.y, u.y, norm, p.s),
          qsgd_one(g.z, u.z, norm, p.s), qsgd_one(g.w, u.w, norm, p.s));
    } else {
      p.out[i] = qsgd_one(p.g[i], p.u[i], norm, p.s);
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace
}  // namespace repro

// g, u fp32 [R, C] contiguous; out int8 [R, C]; norm fp32
// [R / rows_per_segment]; 1 <= s_levels <= 127.  Returns cudaGetLastError()
// after the launch.
extern "C" int repro_qsgd_compress(const void* g, const void* u,
                                   const void* norm, void* out, int R, int C,
                                   int rows_per_segment, int s_levels,
                                   void* stream) {
  if (R <= 0 || C <= 0 || rows_per_segment <= 0 || R % rows_per_segment ||
      s_levels < 1 || s_levels > 127)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::QsgdParams p{static_cast<const float*>(g),
                      static_cast<const float*>(u),
                      static_cast<const float*>(norm),
                      static_cast<int8_t*>(out),
                      static_cast<long long>(R) * C, C, rows_per_segment,
                      static_cast<float>(s_levels)};
  const bool vec = C % 4 == 0 && repro::aligned(g, 16) &&
                   repro::aligned(u, 16) && repro::aligned(out, 4);
  const int per_block = repro::kThreads * (vec ? 4 : 1);
  const long long want = (p.n + per_block - 1) / per_block;
  const long long most = static_cast<long long>(repro::device_sms()) *
                         repro::kBlocksPerSM;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    repro::qsgd_kernel<4><<<blocks, repro::kThreads, 0, st>>>(p);
  else
    repro::qsgd_kernel<1><<<blocks, repro::kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
