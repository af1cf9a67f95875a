// One-token grouped-query decode attention for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_decode
// and computes what it computes: q [B,1,H,hd] against the cache
// ck, cv [B,L,KV,hd] with an online softmax in fp32, scale 1/sqrt(hd),
// output in q's dtype.  Mask: kpos < L and either kpos <= pos (full cache)
// or, for a ring buffer of window W, age = (pos - kpos) mod W and
// pos - age >= 0.  Unlike the Pallas kernel, pos is a device tensor [B]:
// every batch row decodes at its own position, with no host sync.
//
// What bounds it on this card: bytes.  Each step must read the valid
// cache rows, 2*B*L*KV*hd*itemsize bytes per layer at most, and does only
// 4*H*hd FLOPs per cache row read.  What the design does about it: one
// block per (KV head, batch row) reads that head's cache rows once and
// serves all H/KV query heads of the group from shared memory (no
// repeated K/V), reads 4 elements per thread per load, and stops at the
// last row a full cache can hold (pos), so short sequences read little.
// With B*KV blocks the card is not full at small batch: splitting the
// cache over more blocks (split-K) is later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;                      // cache rows per tile

size_t smem_bytes(int G, int HD) {
  // K tile padded to HD+1 columns (thread j reads row j conflict-free),
  // V tile, scaled q, scores, accumulator, and (m, l, alpha) per head
  return sizeof(float) * (kBK * (HD + 1) + kBK * HD + G * HD + G * kBK +
                          G * HD + 3 * G);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                    const T* __restrict__ cv, const int* __restrict__ pos_b,
                    T* __restrict__ o, int L, int H, int KV, int window,
                    float scale) {
  extern __shared__ float smem[];
  constexpr int KS = HD + 1;
  const int G = H / KV;
  float* ks = smem;                  // [kBK][HD+1]
  float* vs = ks + kBK * KS;         // [kBK][HD]  (offset is a multiple of 4)
  float* qs = vs + kBK * HD;         // [G][HD]
  float* ps = qs + G * HD;           // [G][kBK] scores, then probabilities
  float* acc = ps + G * kBK;         // [G][HD]
  float* stat = acc + G * HD;        // [G][3]: m, l, alpha

  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int pos = pos_b[b];
  const size_t q_off = ((size_t)b * H + (size_t)kvh * G) * HD;  // group's heads

  for (int idx = tid; idx < G * HD; idx += kThreads) {
    qs[idx] = to_float(q[q_off + idx]) * scale;
    acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    stat[3 * g] = -1e30f;
    stat[3 * g + 1] = 0.f;
  }

  // a full cache holds nothing past pos; a ring buffer may be valid anywhere
  const int n_keys = window > 0 ? L : min(L, pos + 1);
  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();                         // previous tile consumed
    for (int idx = tid; idx < kBK * (HD / 4); idx += kThreads) {
      const int j = idx / (HD / 4), c = idx % (HD / 4), kp = k0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kp < n_keys) {
        const size_t off = (((size_t)b * L + kp) * KV + kvh) * HD + 4 * c;
        kk = load4(ck + off);
        vv = load4(cv + off);
      }
      float* kr = ks + j * KS + 4 * c;
      kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
      store4(vs + j * HD + 4 * c, vv);
    }
    __syncthreads();

    for (int idx = tid; idx < G * kBK; idx += kThreads) {
      const int g = idx / kBK, j = idx % kBK, kp = k0 + j;
      const float* qg = qs + g * HD;
      const float* kr = ks + j * KS;
      float d = 0.f;
#pragma unroll 16
      for (int t = 0; t < HD; ++t) d = fmaf(qg[t], kr[t], d);
      bool ok = kp < n_keys;
      if (ok && window > 0) {
        const int age = ((pos - kp) % window + window) % window;  // floor mod
        ok = pos - age >= 0;
      }
      ps[idx] = ok ? d : -INFINITY;          // exp(-inf - m) == 0
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {   // one warp per head
      float* pg = ps + g * kBK;
      float mt = -INFINITY;
      for (int j = lane; j < kBK; j += 32) mt = fmaxf(mt, pg[j]);
      const float m_old = stat[3 * g];
      const float m_new = fmaxf(m_old, warp_max(mt));  // finite
      float sum = 0.f;
      for (int j = lane; j < kBK; j += 32) {
        const float p = expf(pg[j] - m_new);
        pg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        stat[3 * g] = m_new;
        stat[3 * g + 1] = stat[3 * g + 1] * alpha + sum;
        stat[3 * g + 2] = alpha;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * HD; idx += kThreads) {
      const int g = idx / HD, d = idx % HD;
      const float* pg = ps + g * kBK;
      float a = 0.f;
#pragma unroll 16
      for (int j = 0; j < kBK; ++j) a = fmaf(pg[j], vs[j * HD + d], a);
      acc[idx] = acc[idx] * stat[3 * g + 2] + a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += kThreads)
    from_float(o + q_off + idx, acc[idx] / fmaxf(stat[3 * (idx / HD) + 1], 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* ck, const void* cv, const int* pos,
           void* o, int B, int L, int H, int KV, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, HD);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_decode_kernel<T, HD><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), pos, static_cast<T*>(o), L, H, KV, window,
      rsqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* ck, const void* cv,
             const int* pos, void* o, int B, int L, int H, int KV, int window,
             cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, ck, cv, pos, o, B, L, H, KV, window, stream);
    case 64: return launch<T, 64>(q, ck, cv, pos, o, B, L, H, KV, window, stream);
    case 128: return launch<T, 128>(q, ck, cv, pos, o, B, L, H, KV, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// q [B,1,H,hd], ck/cv [B,L,KV,hd], pos int32 [B] on the device, o [B,1,H,hd],
// all contiguous, one dtype (0 = float32, 1 = bfloat16).  Returns
// cudaGetLastError() after launch.
extern "C" int repro_flash_decode(const void* q, const void* ck,
                                  const void* cv, const void* pos, void* o,
                                  int B, int L, int H, int KV, int head_dim,
                                  int window, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(head_dim, q, ck, cv, p, o, B, L, H, KV,
                                  window, st);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(head_dim, q, ck, cv, p, o, B, L, H,
                                          KV, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
