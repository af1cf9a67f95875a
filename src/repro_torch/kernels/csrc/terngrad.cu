// TernGrad stochastic ternarization (Wen et al.) for Hopper, sm_90a.
//
// Replaces both Pallas TPU kernels of src/repro/kernels/terngrad/terngrad.py,
// which share one kernel body there (`_kernel`, with stats = [sigma, s]):
//
//   terngrad_ternarize   pre-clipped rows against an external scale s
//                        (sigma = 0: no clip), the segment codec's entry;
//   terngrad_compress    clip to +-sigma (sigma = clip_sigma * std(g),
//                        computed outside), then the same ternarization.
//
// Elementwise over g, u [R, C] (fp32; u uniform in [0, 1), drawn outside):
//
//   gc   = sigma > 0 ? clip(g, -sigma, sigma) : g
//   tern = sign(gc) * (u < |gc| / max(s, 1e-30))        int8 [R, C]
//
// with sign(0) = 0.  sigma (or null: no clip) and s are device vectors with
// one entry per segment of `rows_per_segment` rows: the compressor's
// per-leaf call has one segment, the segment codec one per worker.  The
// statistics (std, max|gc|) are reductions taken outside, as in JAX.
//
// Rounding: the quotient is __fdiv_rn (IEEE, no fast math), so the plane
// equals the plain version's bit for bit given the same u, sigma and s.
//
// What bounds it on this card: bytes.  Per element it reads g and u and
// writes one int8 (9 B) for a handful of operations.  What the design does
// about it: one pass, a grid-stride loop reading 16-byte vectors (float4)
// and writing 4-byte vectors when C % 4 == 0 and the pointers are aligned,
// else one element at a time.
#include <cstdint>

#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

struct TernParams {
  const float* g;
  const float* u;
  const float* sigma;      // nullptr: no clipping (terngrad_ternarize)
  const float* s;          // [segments]
  int8_t* out;
  long long n;             // R * C
  int C;
  int rows_per_segment;
};

__device__ __forceinline__ int8_t tern_one(float g, float u, float sigma,
                                           float s) {
  if (sigma > 0.f) g = fminf(fmaxf(g, -sigma), sigma);
  const float p = __fdiv_rn(fabsf(g), fmaxf(s, 1e-30f));
  const int keep = u < p ? 1 : 0;
  const int sign = (g > 0.f) - (g < 0.f);
  return static_cast<int8_t>(sign * keep);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) terngrad_kernel(TernParams p) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads * VEC;
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * VEC;
       i < p.n; i += step) {
    const int seg = static_cast<int>((i / p.C) / p.rows_per_segment);
    const float sigma = p.sigma != nullptr ? p.sigma[seg] : 0.f;
    const float s = p.s[seg];
    if constexpr (VEC == 4) {
      const float4 g = *reinterpret_cast<const float4*>(p.g + i);
      const float4 u = *reinterpret_cast<const float4*>(p.u + i);
      *reinterpret_cast<char4*>(p.out + i) = make_char4(
          tern_one(g.x, u.x, sigma, s), tern_one(g.y, u.y, sigma, s),
          tern_one(g.z, u.z, sigma, s), tern_one(g.w, u.w, sigma, s));
    } else {
      p.out[i] = tern_one(p.g[i], p.u[i], sigma, s);
    }
  }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace
}  // namespace repro

// g, u fp32 [R, C] contiguous; out int8 [R, C]; sigma (may be null) and s
// fp32 [R / rows_per_segment].  Returns cudaGetLastError() after the launch.
extern "C" int repro_terngrad(const void* g, const void* u, const void* sigma,
                              const void* s, void* out, int R, int C,
                              int rows_per_segment, void* stream) {
  if (R <= 0 || C <= 0 || rows_per_segment <= 0 || R % rows_per_segment)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::TernParams p{static_cast<const float*>(g),
                      static_cast<const float*>(u),
                      static_cast<const float*>(sigma),
                      static_cast<const float*>(s), static_cast<int8_t*>(out),
                      static_cast<long long>(R) * C, C, rows_per_segment};
  const bool vec = C % 4 == 0 && repro::aligned(g, 16) &&
                   repro::aligned(u, 16) && repro::aligned(out, 4);
  const int per_block = repro::kThreads * (vec ? 4 : 1);
  const long long want = (p.n + per_block - 1) / per_block;
  const unsigned blocks = static_cast<unsigned>(
      want < repro::kMaxBlocks ? want : repro::kMaxBlocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    repro::terngrad_kernel<4><<<blocks, repro::kThreads, 0, st>>>(p);
  else
    repro::terngrad_kernel<1><<<blocks, repro::kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
