// TernGrad stochastic ternarization (Wen et al.) for Hopper, sm_90a.
//
// Replaces both Pallas TPU kernels of src/repro/kernels/terngrad/terngrad.py,
// which share one kernel body there (`_kernel`, with stats = [sigma, s]):
//
//   terngrad_ternarize   pre-clipped rows against an external scale s
//                        (sigma = 0: no clip), the segment codec's entry;
//   terngrad_compress    clip to +-sigma (sigma = clip_sigma * std(g),
//                        computed outside), then the same ternarization
//                        against s = max|clip(g)|.
//
// Elementwise over g, u [R, C] (fp32; u uniform in [0, 1), drawn outside):
//
//   gc   = sigma > 0 ? clip(g, -sigma, sigma) : g
//   tern = sign(gc) * (u < |gc| / max(s, 1e-30))        int8 [R, C]
//
// with sign(0) = 0.  For terngrad_ternarize, sigma (or null: no clip) and
// s are device vectors with one entry per segment of `rows_per_segment`
// rows: the compressor's per-leaf call has one segment, the segment codec
// one per worker.
//
// Rounding: the quotient is __fdiv_rn (IEEE, no fast math), so the plane
// equals the plain version's bit for bit given the same u, sigma and s.
//
// What bounds it on this card: bytes.  Per element it reads g and u and
// writes one int8 (9 B) for a handful of operations: one pass, a
// grid-stride loop (32 blocks per SM) reading 16-byte vectors (float4) and
// writing 4-byte vectors when C % 4 == 0 and the pointers are aligned, else
// one element at a time.
//
// terngrad_compress needs sigma (std, one reduction over g) before its
// output, and s = max|clip(g)| = min(max|g|, sigma) when sigma > 0, else
// max|g|.  g (1.0 GB for the stacked w_down leaf) cannot stay in the 50 MB
// L2 between a reduction and the output, so the floor is two passes over
// g: 13 B per element.  The std stays outside, the plain version's own
// torch.var_mean, so sigma is bit for bit the plain version's; the max
// needs no pass of its own.  `repro_terngrad_compress` ternarizes against
// the provisional scale s = sigma and, in the same pass, folds max|g| into
// one device word with atomicMax on its bits (non-negative floats order
// like their bits, so the max is exact and order-free).  A finishing
// kernel then writes s = sigma > 0 ? min(max|g|, sigma) : max|g|; only when
// that differs from sigma (no element reached the clip, or a zero or NaN
// std) does it ternarize the whole tensor again against it.  On a gradient
// whose tails pass 2.5 sigma it exits at once.
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 32;     // grid-stride blocks per SM
constexpr int kFinishPerSM = 4;      // finishing kernel: blocks per SM

struct TernParams {
  const float* g;
  const float* u;
  const float* sigma;      // nullptr: no clipping (terngrad_ternarize)
  const float* s;          // [segments]
  int8_t* out;
  long long n;             // R * C
  int C;
  int rows_per_segment;
  unsigned* amax;          // max|g| as bits (terngrad_compress), or nullptr
};

__device__ __forceinline__ int8_t tern_one(float g, float u, float sigma,
                                           float s) {
  if (sigma > 0.f) g = fminf(fmaxf(g, -sigma), sigma);
  const float p = __fdiv_rn(fabsf(g), fmaxf(s, 1e-30f));
  const int keep = u < p ? 1 : 0;
  const int sign = (g > 0.f) - (g < 0.f);
  return static_cast<int8_t>(sign * keep);
}

__device__ __forceinline__ unsigned abs_bits(float g) {
  return __float_as_uint(fabsf(g));
}

// One grid-stride pass over the elements; `stats(seg)` gives segment
// seg's (sigma, s).  Returns the largest |g| this thread read, as bits.
template <int VEC, typename Stats>
__device__ __forceinline__ unsigned tern_pass(const TernParams& p,
                                              Stats stats) {
  unsigned m = 0;
  const long long step = static_cast<long long>(gridDim.x) * kThreads * VEC;
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * VEC;
       i < p.n; i += step) {
    const float2 st = stats(static_cast<int>((i / p.C) / p.rows_per_segment));
    if constexpr (VEC == 4) {
      const float4 g = *reinterpret_cast<const float4*>(p.g + i);
      const float4 u = *reinterpret_cast<const float4*>(p.u + i);
      *reinterpret_cast<char4*>(p.out + i) = make_char4(
          tern_one(g.x, u.x, st.x, st.y), tern_one(g.y, u.y, st.x, st.y),
          tern_one(g.z, u.z, st.x, st.y), tern_one(g.w, u.w, st.x, st.y));
      m = max(max(m, max(abs_bits(g.x), abs_bits(g.y))),
              max(abs_bits(g.z), abs_bits(g.w)));
    } else {
      const float g = p.g[i];
      p.out[i] = tern_one(g, p.u[i], st.x, st.y);
      m = max(m, abs_bits(g));
    }
  }
  return m;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) terngrad_kernel(TernParams p) {
  const unsigned m = tern_pass<VEC>(p, [&](int seg) {
    return make_float2(p.sigma != nullptr ? p.sigma[seg] : 0.f, p.s[seg]);
  });
  if (p.amax == nullptr) return;
  // the block's max, then one atomic per block
  __shared__ unsigned warp_max[kThreads / 32];
  const unsigned w = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = w;
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned b = __reduce_max_sync(
        0xffffffffu, threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u);
    if (threadIdx.x == 0) atomicMax(p.amax, b);
  }
}

// The scale of terngrad_compress from sigma and max|g|, into s_out; the
// plane again against it where it is not the provisional sigma.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
terngrad_finish_kernel(TernParams p, float* s_out) {
  const float sigma = *p.sigma;
  const float amax = __uint_as_float(*p.amax);
  const float s = sigma > 0.f ? fminf(amax, sigma) : amax;
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  if (s == sigma) return;                 // the provisional plane stands
  tern_pass<VEC>(p, [=](int) { return make_float2(sigma, s); });
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// grid of a pass over p.n elements, at most `per_sm` blocks per SM
unsigned grid(const TernParams& p, bool vec, int per_sm) {
  const int per_block = kThreads * (vec ? 4 : 1);
  const long long want = (p.n + per_block - 1) / per_block;
  const long long most = static_cast<long long>(device_sms()) * per_sm;
  return static_cast<unsigned>(want < most ? want : most);
}

bool vectorized(const TernParams& p) {
  return p.C % 4 == 0 && aligned(p.g, 16) && aligned(p.u, 16) &&
         aligned(p.out, 4);
}

void launch(const TernParams& p, cudaStream_t st) {
  const bool vec = vectorized(p);
  const unsigned blocks = grid(p, vec, kBlocksPerSM);
  if (vec)
    terngrad_kernel<4><<<blocks, kThreads, 0, st>>>(p);
  else
    terngrad_kernel<1><<<blocks, kThreads, 0, st>>>(p);
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
  const repro::TernParams p{
      static_cast<const float*>(g), static_cast<const float*>(u),
      static_cast<const float*>(sigma), static_cast<const float*>(s),
      static_cast<int8_t*>(out), static_cast<long long>(R) * C, C,
      rows_per_segment, nullptr};
  repro::launch(p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// terngrad_compress with clip: g, u fp32 [R, C] contiguous; sigma fp32 [1]
// (clip_sigma * std(g)); stats fp32 [2], zeroed: [0] receives max|g| (as
// bits), [1] the scale s; out int8 [R, C].  Two launches, no host sync.
// Returns cudaGetLastError() after them.
extern "C" int repro_terngrad_compress(const void* g, const void* u,
                                       const void* sigma, void* stats,
                                       void* out, int R, int C, void* stream) {
  if (R <= 0 || C <= 0 || sigma == nullptr || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  repro::TernParams p{
      static_cast<const float*>(g), static_cast<const float*>(u),
      static_cast<const float*>(sigma), static_cast<const float*>(sigma),
      static_cast<int8_t*>(out), static_cast<long long>(R) * C, C, R,
      static_cast<unsigned*>(stats)};
  repro::launch(p, st);                          // against s = sigma
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  p.s = nullptr;
  const bool vec = repro::vectorized(p);
  const unsigned blocks = repro::grid(p, vec, repro::kFinishPerSM);
  float* s_out = static_cast<float*>(stats) + 1;
  if (vec)
    repro::terngrad_finish_kernel<4><<<blocks, repro::kThreads, 0, st>>>(p, s_out);
  else
    repro::terngrad_finish_kernel<1><<<blocks, repro::kThreads, 0, st>>>(p, s_out);
  return static_cast<int>(cudaGetLastError());
}
