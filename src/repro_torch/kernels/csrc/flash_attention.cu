// Flash-attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
// and computes what it computes: causal, sliding-window or full
// online-softmax attention, q [B,S,H,hd] against k, v [B,S,KV,hd], query
// head h reading KV head h / (H/KV), scale 1/sqrt(hd), fp32 running max,
// normaliser and accumulator, output in q's dtype.  Masks: key padding
// kpos < S, causal kpos <= qpos, window kpos > qpos - W.
//
// What bounds it on this card: at prefill lengths it is bound by
// operations (4*S*S_vis*H*hd FLOPs against 2*S*(H+2KV)*hd*itemsize bytes);
// it reads each K/V tile from device memory once per 64-row query tile.
// What the design does about it: one block per (64-row query tile, head,
// batch row); K/V tiles are staged in shared memory as fp32 and reused by
// all 64 query rows; 4 threads share a query row (each owns hd/4 of its
// columns, summed with two warp shuffles), so q, the accumulator and the
// tile's scores stay in registers; tiles wholly above the causal diagonal
// or wholly before the window are never loaded.  The dot products run on
// the CUDA cores in fp32: tensor cores (wgmma) and TMA are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBlockQ = 64;                          // query rows per block
constexpr int kThreadsPerRow = 4;                    // threads sharing a row
constexpr int kThreads = kBlockQ * kThreadsPerRow;   // 256

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KV, int causal, int window, float scale) {
  constexpr int C4 = HD / 4;                 // float4 columns of a row
  constexpr int NV = C4 / kThreadsPerRow;    // float4 columns per thread
  __shared__ float4 ks[BK][C4];
  __shared__ float4 vs[BK][C4];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int qpos = q0 + tid / kThreadsPerRow;
  const int kvh = h / (H / KV);
  const bool row_valid = qpos < S;

  // thread `part` owns float4 columns part, part+4, ...: the 4 threads of
  // a row read 4 neighbouring float4s of a K/V row, free of bank conflicts
  const size_t q_off = ((size_t)(b * S + qpos) * H + h) * HD;
  float4 qr[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * kThreadsPerRow + part;
    qr[i] = row_valid ? scale4(load4(q + q_off + 4 * c), scale)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -1e30f, l = 0.f;

  // key tiles this query tile can see: causal stops at its last row, a
  // window starts W-1 keys before its first row
  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  const int k_first = (causal && window > 0) ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_first / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();                         // previous tile consumed
    for (int idx = tid; idx < BK * C4; idx += kThreads) {
      const int j = idx / C4, c = idx % C4, kp = k0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kp < S) {
        const size_t off = ((size_t)(b * S + kp) * KV + kvh) * HD + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[BK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        d += dot4(qr[i], ks[j][i * kThreadsPerRow + part]);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int kp = k0 + j;
      bool ok = kp < S;
      if (causal) ok = ok && kp <= qpos && (window <= 0 || kp > qpos - window);
      s[j] = ok ? d : -INFINITY;             // exp(-inf - m) == 0
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);    // finite: m starts at -1e30
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = scale4(acc[i], alpha);
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        acc[i] = fma4(p, vs[j][i * kThreadsPerRow + part], acc[i]);
    }
    m = m_new;
  }

  if (row_valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      store4(o + q_off + 4 * (i * kThreadsPerRow + part), scale4(acc[i], inv));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int causal, int window, cudaStream_t stream) {
  constexpr int BK = HD > 64 ? 32 : 64;      // 32 KB of K/V tiles at most
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, HD, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, window,
      rsqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             void* o, int B, int S, int H, int KV, int causal, int window,
             cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// q [B,S,H,hd], k/v [B,S,KV,hd], o [B,S,H,hd], all contiguous, one dtype
// (0 = float32, 1 = bfloat16).  Returns cudaGetLastError() after launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int H, int KV, int head_dim, int causal,
                                     int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(head_dim, q, k, v, o, B, S, H, KV, causal,
                                  window, st);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(head_dim, q, k, v, o, B, S, H, KV,
                                          causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
