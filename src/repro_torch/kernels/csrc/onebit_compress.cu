// Symmetric 1-bit compression with error feedback for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/onebit/onebit.py::onebit_compress
// and computes what it computes, row by row over g, e [R, C] (fp32):
//
//   c      = g + e
//   signs  = c >= 0 ? +1 : -1                            int8 [R, C]
//   scale  = mean |c| over the row                       fp32 [R, 1]
//   new_e  = c - sign * scale                            fp32 [R, C]
//
// Rounding: c is __fadd_rn(g, e), scale is __fdiv_rn(sum |c|, C) and
// new_e is __fsub_rn(c, __fmul_rn(sign, scale)): no fast math and no
// contraction, so the signs are the plain version's bit for bit (c = 0
// gives +1) and scale and new_e differ from it only by the order in which
// the row sum is taken.
//
// What bounds it on this card: bytes.  Per element it reads g and e and
// writes the sign and new_e (4 + 4 + 1 + 4 = 13 B), plus 4 B per row for
// the scale, against ~4 flops: far below the ridge.
// What the design does about it: one pass over the row for sum |c| (fp32,
// reduced with warp shuffles, then shared memory across warps) and a
// second that recomputes c from a re-read of the row and writes both
// outputs.  A 256-thread block owns a row of 1024 or more elements (the
// lm_head leaf's rows are 32000 wide), one warp a narrower row (8 rows per
// block); rows are walked in 16-byte vectors where C % 4 == 0 and element
// by element otherwise, so C need not be a power of two.  The second read
// of g and e mostly comes from L2 (cp.async / TMA staging is later work).
#include <cstdint>

#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int kBlockThreads = 256;

struct CompressParams {
  const float* g;
  const float* e;
  int8_t* signs;
  float* scale;
  float* new_e;
  int R, C;
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  return s;
}

__device__ __forceinline__ void encode(float g, float e, float scale,
                                       int8_t& sign, float& ne) {
  const float c = __fadd_rn(g, e);
  sign = c >= 0.f ? 1 : -1;
  ne = __fsub_rn(c, __fmul_rn(static_cast<float>(sign), scale));
}

// TPR threads own one row (TPR = 32: one warp; TPR = 256: the block).
// VEC = 4 walks the row in float4 / char4 vectors (needs C % 4 == 0).
template <int TPR, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
onebit_compress_kernel(CompressParams p) {
  constexpr int kRowsPerBlock = kBlockThreads / TPR;
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  const bool row_ok = row < p.R;
  const size_t base = static_cast<size_t>(row_ok ? row : 0) * p.C;
  const float* g = p.g + base;
  const float* e = p.e + base;

  // ---- pass 1: sum |c| over the row
  float s = 0.f;
  if (row_ok) {
    for (int c = lane * VEC; c < p.C; c += TPR * VEC) {
      if constexpr (VEC == 4) {
        const float4 gv = *reinterpret_cast<const float4*>(g + c);
        const float4 ev = *reinterpret_cast<const float4*>(e + c);
        s = __fadd_rn(s, fabsf(__fadd_rn(gv.x, ev.x)));
        s = __fadd_rn(s, fabsf(__fadd_rn(gv.y, ev.y)));
        s = __fadd_rn(s, fabsf(__fadd_rn(gv.z, ev.z)));
        s = __fadd_rn(s, fabsf(__fadd_rn(gv.w, ev.w)));
      } else {
        s = __fadd_rn(s, fabsf(__fadd_rn(g[c], e[c])));
      }
    }
  }
  s = warp_sum(s);
  if constexpr (TPR > 32) {
    __shared__ float part[kBlockThreads / 32];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) part[warp] = s;
    __syncthreads();
    if (threadIdx.x < 32) {
      s = threadIdx.x < kBlockThreads / 32 ? part[threadIdx.x] : 0.f;
      s = warp_sum(s);
      if (threadIdx.x == 0) part[0] = s;
    }
    __syncthreads();
    s = part[0];
  }
  if (!row_ok) return;

  const float scale = __fdiv_rn(s, static_cast<float>(p.C));
  if (lane == 0) p.scale[row] = scale;

  // ---- pass 2: signs and the next residual
  int8_t* so = p.signs + base;
  float* eo = p.new_e + base;
  for (int c = lane * VEC; c < p.C; c += TPR * VEC) {
    if constexpr (VEC == 4) {
      const float4 gv = *reinterpret_cast<const float4*>(g + c);
      const float4 ev = *reinterpret_cast<const float4*>(e + c);
      int8_t sx, sy, sz, sw;
      float4 nv;
      encode(gv.x, ev.x, scale, sx, nv.x);
      encode(gv.y, ev.y, scale, sy, nv.y);
      encode(gv.z, ev.z, scale, sz, nv.z);
      encode(gv.w, ev.w, scale, sw, nv.w);
      *reinterpret_cast<char4*>(so + c) = make_char4(sx, sy, sz, sw);
      *reinterpret_cast<float4*>(eo + c) = nv;
    } else {
      encode(g[c], e[c], scale, so[c], eo[c]);
    }
  }
}

template <int TPR>
int launch(const CompressParams& p, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kBlockThreads / TPR;
  const unsigned blocks = (p.R + kRowsPerBlock - 1) / kRowsPerBlock;
  if (p.C % 4 == 0)
    onebit_compress_kernel<TPR, 4><<<blocks, kBlockThreads, 0, stream>>>(p);
  else
    onebit_compress_kernel<TPR, 1><<<blocks, kBlockThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// g, e, new_e fp32 [R, C]; signs int8 [R, C]; scale fp32 [R]; all
// contiguous and 16-byte aligned.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_onebit_compress(const void* g, const void* e,
                                     void* signs, void* scale, void* new_e,
                                     int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  repro::CompressParams p{static_cast<const float*>(g),
                          static_cast<const float*>(e),
                          static_cast<int8_t*>(signs),
                          static_cast<float*>(scale),
                          static_cast<float*>(new_e), R, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return C >= 1024 ? repro::launch<256>(p, st) : repro::launch<32>(p, st);
}
