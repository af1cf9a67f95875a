// DGC threshold sparsification with error accumulation, for Hopper sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/topk/topk.py::topk_compress
// and computes what it computes, elementwise over g [R, C] (fp32) with an
// optional residual e [R, C] (null: no residual):
//
//   c     = g + e                                  (c = g without e)
//   out   = |c| >= t ? c : 0                       fp32 [R, C]
//   new_e = c - out                                fp32 [R, C]
//
// The threshold t is a device vector with one entry per segment of
// `rows_per_segment` rows: the compressor's per-leaf call has one segment,
// the segment codecs one per worker.  The threshold itself (a quantile of
// |c|) is computed outside, as in the JAX package.
//
// Rounding: c is __fadd_rn(g, e) and new_e __fsub_rn(c, out), so the
// kept set and both outputs equal the plain version's bit for bit.
//
// What bounds it on this card: bytes.  Per element it reads g and e and
// writes out and new_e (16 B) for three operations.  What the design does
// about it: one pass, a grid-stride loop in 16-byte vectors (float4) when
// C % 4 == 0 and every pointer is 16-byte aligned, else one element at a
// time; enough blocks to keep every SM's loads in flight.
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 32;   // grid-stride blocks per SM

struct TopkParams {
  const float* g;
  const float* e;          // nullptr: no residual
  const float* t;          // [segments]
  float* out;
  float* new_e;
  long long n;             // R * C
  int C;
  int rows_per_segment;
};

__device__ __forceinline__ void topk_one(float g, float e, bool has_e, float t,
                                         float& out, float& new_e) {
  const float c = has_e ? __fadd_rn(g, e) : g;
  out = fabsf(c) >= t ? c : 0.f;
  new_e = __fsub_rn(c, out);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
topk_compress_kernel(TopkParams p) {
  const bool has_e = p.e != nullptr;
  const long long step = static_cast<long long>(gridDim.x) * kThreads * VEC;
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * VEC;
       i < p.n; i += step) {
    const float t = p.t[(i / p.C) / p.rows_per_segment];
    if constexpr (VEC == 4) {
      const float4 g = *reinterpret_cast<const float4*>(p.g + i);
      const float4 e = has_e ? *reinterpret_cast<const float4*>(p.e + i)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 o, ne;
      topk_one(g.x, e.x, has_e, t, o.x, ne.x);
      topk_one(g.y, e.y, has_e, t, o.y, ne.y);
      topk_one(g.z, e.z, has_e, t, o.z, ne.z);
      topk_one(g.w, e.w, has_e, t, o.w, ne.w);
      *reinterpret_cast<float4*>(p.out + i) = o;
      *reinterpret_cast<float4*>(p.new_e + i) = ne;
    } else {
      topk_one(p.g[i], has_e ? p.e[i] : 0.f, has_e, t, p.out[i], p.new_e[i]);
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace
}  // namespace repro

// g, e, out, new_e fp32 [R, C] contiguous; e may be null; t fp32
// [R / rows_per_segment].  Returns cudaGetLastError() after the launch.
extern "C" int repro_topk_compress(const void* g, const void* e,
                                   const void* t, void* out, void* new_e,
                                   int R, int C, int rows_per_segment,
                                   void* stream) {
  if (R <= 0 || C <= 0 || rows_per_segment <= 0 || R % rows_per_segment)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::TopkParams p{static_cast<const float*>(g),
                      static_cast<const float*>(e),
                      static_cast<const float*>(t), static_cast<float*>(out),
                      static_cast<float*>(new_e),
                      static_cast<long long>(R) * C, C, rows_per_segment};
  const bool vec = C % 4 == 0 && repro::aligned16(g) &&
                   (e == nullptr || repro::aligned16(e)) &&
                   repro::aligned16(out) && repro::aligned16(new_e);
  const int per_block = repro::kThreads * (vec ? 4 : 1);
  const long long want = (p.n + per_block - 1) / per_block;
  const long long most = static_cast<long long>(repro::device_sms()) *
                         repro::kBlocksPerSM;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    repro::topk_compress_kernel<4><<<blocks, repro::kThreads, 0, st>>>(p);
  else
    repro::topk_compress_kernel<1><<<blocks, repro::kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
