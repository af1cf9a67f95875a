// Fused 1-bit encode + error-feedback residual for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/onebit/fused.py::onebit_encode_ef
// and computes what it computes, row by row over g [R, C] (fp32), with an
// optional residual e [R, C] and an optional valid mask [R, C] (bool):
//
//   c_in   = g + gain * e      (c_in = g when there is no e)
//   c_true = g + e
//   signs  = c_in >= 0 ? +1 : -1                        int8 [R, C]
//   sp, sn = mean of c_in over the valid positives, mean of -c_in over
//            the valid negatives (counts clamped to 1); both mean|c_in|
//            over the row when `symmetric`                 fp32 [R, 1]
//   out    = valid ? (sign > 0 ? sp : -sn) : 0             fp32 [R, C]
//   new_e  = c_true - out                                  fp32 [R, C]
//
// Rounding: c_in is __fadd_rn(g, __fmul_rn(gain, e)), two rounded
// operations as in the plain version, never one FMA, so the signs are the
// plain version's bit for bit; the divisions are IEEE (no fast math).
// sp and sn differ from the plain version only by summation order.
//
// What bounds it on this card: bytes.  Per element it reads g and e and
// writes the sign, out and new_e (4 + 4 + 1 + 4 + 4 = 17 B), plus 8 B per
// row for sp and sn, against ~10 flops: far below the ridge.
// What the design does about it: one pass over the row for the bin sums
// (reduced with warp shuffles, then shared memory across warps) and a
// second that recomputes c_in from a re-read of the row and writes every
// output.  A group of threads owns a row and walks it in 16-byte vectors
// where C % 4 == 0: a 256-thread block for rows of 1024 or more elements
// (C reaches 32000 on the lm_head leaf), one warp for narrower rows (8
// rows per block), so neither the widest nor the narrowest leaf leaves
// the card idle.  The Pallas kernel holds a whole (rows, C) tile in VMEM;
// here no row has to fit on chip, and the second read comes from L2 when
// the rows in flight fit in its 50 MB (cp.async / TMA staging is later
// work).
#include <cstdint>

#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int kBlockThreads = 256;

struct Params {
  const float* g;
  const float* e;          // nullptr: no error feedback
  const bool* valid;       // nullptr: every element is real
  int8_t* signs;
  float* sp;
  float* sn;
  float* out;
  float* new_e;
  int R, C;
  float gain;
  int symmetric;
};

struct Sums {
  float pos, neg;          // sum of c_in over valid positives, -c_in over negatives
  int npos, nneg;
};

__device__ __forceinline__ float c_in_of(float g, float e, bool has_e,
                                         float gain) {
  return has_e ? __fadd_rn(g, __fmul_rn(gain, e)) : g;
}

__device__ __forceinline__ void accumulate(Sums& s, float cin, bool valid,
                                           bool symmetric) {
  if (symmetric) {
    s.pos += fabsf(cin);
    return;
  }
  if (!valid) return;
  if (cin >= 0.f) {
    s.pos += cin;
    s.npos += 1;
  } else {
    s.neg += -cin;
    s.nneg += 1;
  }
}

__device__ __forceinline__ Sums warp_sum(Sums s) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s.pos += __shfl_xor_sync(0xffffffffu, s.pos, d);
    s.neg += __shfl_xor_sync(0xffffffffu, s.neg, d);
    s.npos += __shfl_xor_sync(0xffffffffu, s.npos, d);
    s.nneg += __shfl_xor_sync(0xffffffffu, s.nneg, d);
  }
  return s;
}

// TPR threads own one row (TPR = 32: one warp; TPR = 256: the block).
// VEC = 4 walks the row in float4 / char4 vectors (needs C % 4 == 0).
template <int TPR, int VEC>
__global__ void __launch_bounds__(kBlockThreads)
onebit_encode_ef_kernel(Params p) {
  constexpr int kRowsPerBlock = kBlockThreads / TPR;
  const int lane = threadIdx.x % TPR;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  const bool has_e = p.e != nullptr, has_valid = p.valid != nullptr;
  const bool symmetric = p.symmetric != 0;
  const bool row_ok = row < p.R;
  const size_t base = static_cast<size_t>(row_ok ? row : 0) * p.C;
  const float* g = p.g + base;
  const float* e = has_e ? p.e + base : nullptr;
  const bool* v = has_valid ? p.valid + base : nullptr;

  // ---- pass 1: the row's bin sums and counts
  Sums s{0.f, 0.f, 0, 0};
  if (row_ok) {
    for (int c = lane * VEC; c < p.C; c += TPR * VEC) {
      if constexpr (VEC == 4) {
        const float4 gv = *reinterpret_cast<const float4*>(g + c);
        const float4 ev = has_e ? *reinterpret_cast<const float4*>(e + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        const uchar4 vv = has_valid ? *reinterpret_cast<const uchar4*>(v + c)
                                    : make_uchar4(1, 1, 1, 1);
        accumulate(s, c_in_of(gv.x, ev.x, has_e, p.gain), vv.x != 0, symmetric);
        accumulate(s, c_in_of(gv.y, ev.y, has_e, p.gain), vv.y != 0, symmetric);
        accumulate(s, c_in_of(gv.z, ev.z, has_e, p.gain), vv.z != 0, symmetric);
        accumulate(s, c_in_of(gv.w, ev.w, has_e, p.gain), vv.w != 0, symmetric);
      } else {
        accumulate(s, c_in_of(g[c], has_e ? e[c] : 0.f, has_e, p.gain),
                   has_valid ? v[c] : true, symmetric);
      }
    }
  }
  s = warp_sum(s);
  if constexpr (TPR > 32) {
    __shared__ Sums part[kBlockThreads / 32];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) part[warp] = s;
    __syncthreads();
    if (threadIdx.x < 32) {
      s = threadIdx.x < kBlockThreads / 32 ? part[threadIdx.x]
                                           : Sums{0.f, 0.f, 0, 0};
      s = warp_sum(s);
      if (threadIdx.x == 0) part[0] = s;
    }
    __syncthreads();
    s = part[0];
  }
  if (!row_ok) return;

  float sp, sn;
  if (symmetric) {
    sp = sn = __fdiv_rn(s.pos, static_cast<float>(p.C));
  } else {
    sp = __fdiv_rn(s.pos, static_cast<float>(max(s.npos, 1)));
    sn = __fdiv_rn(s.neg, static_cast<float>(max(s.nneg, 1)));
  }
  if (lane == 0) {
    p.sp[row] = sp;
    p.sn[row] = sn;
  }

  // ---- pass 2: signs, reconstruction and the next residual
  int8_t* so = p.signs + base;
  float* oo = p.out + base;
  float* eo = p.new_e + base;
  auto encode = [&](float gi, float ei, bool vi, int8_t& sign, float& o,
                    float& ne) {
    const float cin = c_in_of(gi, ei, has_e, p.gain);
    const float ctrue = has_e ? __fadd_rn(gi, ei) : gi;
    sign = cin >= 0.f ? 1 : -1;
    o = vi ? (sign > 0 ? sp : -sn) : 0.f;
    ne = __fsub_rn(ctrue, o);
  };
  for (int c = lane * VEC; c < p.C; c += TPR * VEC) {
    if constexpr (VEC == 4) {
      const float4 gv = *reinterpret_cast<const float4*>(g + c);
      const float4 ev = has_e ? *reinterpret_cast<const float4*>(e + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const uchar4 vv = has_valid ? *reinterpret_cast<const uchar4*>(v + c)
                                  : make_uchar4(1, 1, 1, 1);
      char4 sv;
      float4 ov, nv;
      int8_t sx, sy, sz, sw;
      encode(gv.x, ev.x, vv.x != 0, sx, ov.x, nv.x);
      encode(gv.y, ev.y, vv.y != 0, sy, ov.y, nv.y);
      encode(gv.z, ev.z, vv.z != 0, sz, ov.z, nv.z);
      encode(gv.w, ev.w, vv.w != 0, sw, ov.w, nv.w);
      sv = make_char4(sx, sy, sz, sw);
      *reinterpret_cast<char4*>(so + c) = sv;
      *reinterpret_cast<float4*>(oo + c) = ov;
      *reinterpret_cast<float4*>(eo + c) = nv;
    } else {
      int8_t sign;
      encode(g[c], has_e ? e[c] : 0.f, has_valid ? v[c] : true, sign, oo[c],
             eo[c]);
      so[c] = sign;
    }
  }
}

template <int TPR>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kBlockThreads / TPR;
  const unsigned blocks = (p.R + kRowsPerBlock - 1) / kRowsPerBlock;
  if (p.C % 4 == 0)
    onebit_encode_ef_kernel<TPR, 4><<<blocks, kBlockThreads, 0, stream>>>(p);
  else
    onebit_encode_ef_kernel<TPR, 1><<<blocks, kBlockThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// g, e, out, new_e fp32 [R, C]; valid bool [R, C]; signs int8 [R, C];
// sp, sn fp32 [R]; all contiguous and 16-byte aligned.  e and valid may be
// null.  Returns cudaGetLastError() after the launch.
extern "C" int repro_onebit_encode_ef(const void* g, const void* e,
                                      const void* valid, void* signs,
                                      void* sp, void* sn, void* out,
                                      void* new_e, int R, int C, float gain,
                                      int symmetric, void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  repro::Params p{static_cast<const float*>(g), static_cast<const float*>(e),
                  static_cast<const bool*>(valid), static_cast<int8_t*>(signs),
                  static_cast<float*>(sp), static_cast<float*>(sn),
                  static_cast<float*>(out), static_cast<float*>(new_e),
                  R, C, gain, symmetric};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return C >= 1024 ? repro::launch<256>(p, st) : repro::launch<32>(p, st);
}
