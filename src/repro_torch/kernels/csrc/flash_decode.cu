// One-token grouped-query decode attention for Hopper, sm_90a: split-K.
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
// 4*H*hd FLOPs per cache row read; at the serving shape (B=8, 4 KV heads,
// 576 rows) that is 4.5 MB, 1.4 us at 3.35 TB/s, so the kernel is a
// matter of keeping enough loads in flight on all 132 SMs at once.
// What the design does about it:
//   - split-K: the grid is (n_split, KV, B); the host picks the chunk of
//     cache rows (a multiple of 16, at most 128) so that about two blocks
//     run on each SM (9 x 4 x 8 = 288 blocks of 64 rows at the serving
//     shape).  A block reads its chunk of one KV head once, with 16-byte
//     cp.async copies all in flight together, and serves the H/KV query
//     heads of the group from shared memory (no repeated K/V);
//   - a chunk that holds no valid row (past pos in a full cache, or only
//     unwritten ring slots, known only on the device) writes the empty
//     partial (m = -1e30, l = 0) and exits before loading anything;
//   - each block writes an fp32 partial (m, l, acc[G, hd]) per query head
//     to a scratch tensor the wrapper allocates; a second kernel,
//     flash_decode_combine_kernel, merges the n_split partials of each
//     (b, h) with weights exp(m_i - M), gives an empty partial the weight 0
//     (never NaN), and writes acc / max(l, 1e-30) in q's dtype;
//   - the products run on the CUDA cores: 4*H*hd FLOPs per row are far
//     below what the bytes allow.  Three __syncthreads per block: after
//     the loads, after the scores, after the softmax.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;

template <typename T>
__host__ __device__ constexpr int vec() { return 16 / static_cast<int>(sizeof(T)); }  // per 16 B

template <typename T>
size_t smem_bytes(int G, int HD, int chunk) {
  // K chunk with rows padded by 16 bytes (8 neighbouring rows read 16-byte
  // pieces from distinct banks), V chunk, scaled q, scores
  return sizeof(T) * chunk * (2 * HD + vec<T>()) +
         sizeof(float) * G * (HD + chunk);
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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// q . k over one 16-byte piece of a cached row (q already in fp32)
__device__ __forceinline__ float dot16(const float* q, const float* k) {
  return dot4(load4(q), load4(k));
}

__device__ __forceinline__ float dot16(const float* q, const __nv_bfloat16* k) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* kk = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 q0 = load4(q), q1 = load4(q + 4);
  const float2 a = __bfloat1622float2(kk[0]), b = __bfloat1622float2(kk[1]);
  const float2 c = __bfloat1622float2(kk[2]), d = __bfloat1622float2(kk[3]);
  return q0.x * a.x + q0.y * a.y + q0.z * b.x + q0.w * b.y +
         q1.x * c.x + q1.y * c.y + q1.z * d.x + q1.w * d.y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

// is cache row kp visible at position pos?  (kp < the rows read)
__device__ __forceinline__ bool visible(int kp, int pos, int window) {
  if (window <= 0) return kp <= pos;
  const int age = ((pos - kp) % window + window) % window;   // floor mod
  return pos - age >= 0;
}

// Partials: acc [B*H, n_split, HD] then (m, l) [B*H, n_split, 2], fp32.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                          const T* __restrict__ cv, const int* __restrict__ pos_b,
                          float* __restrict__ part, int L, int H, int KV,
                          int window, int chunk, float scale) {
  constexpr int V = vec<T>(), CH = HD / V, KS = HD + V;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  T* ks = reinterpret_cast<T*>(smem);                 // [chunk][HD+V]
  T* vs = ks + chunk * KS;                            // [chunk][HD]
  float* qs = reinterpret_cast<float*>(vs + chunk * HD);  // [G][HD]
  float* ps = qs + G * HD;                            // [G][chunk]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int pos = pos_b[b];
  // a full cache holds nothing past pos; a ring buffer may be valid anywhere
  const int c0 = split * chunk;
  const int rows = min(chunk, (window > 0 ? L : min(L, pos + 1)) - c0);
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;
  float* ml = part + static_cast<size_t>(gridDim.z) * H * n_split * HD;

  bool any = false;                                   // a visible row?
  if (window > 0) {
    for (int j = tid; j < rows; j += kThreads) any |= visible(c0 + j, pos, window);
    any = __syncthreads_or(any);
  } else {
    any = rows > 0;
  }
  if (!any) {                                         // the empty partial
    for (int g = tid; g < G; g += kThreads) {
      float* mlg = ml + ((head0 + g) * n_split + split) * 2;
      mlg[0] = -1e30f;
      mlg[1] = 0.f;
    }
    return;
  }

  const size_t row_stride = static_cast<size_t>(KV) * HD;
  const T* kb = ck + (static_cast<size_t>(b) * L + c0) * row_stride +
                static_cast<size_t>(kvh) * HD;
  const T* vb = cv + (kb - ck);
  for (int idx = tid; idx < rows * CH; idx += kThreads) {
    const int j = idx / CH, c = idx % CH;
    cp_async16(ks + j * KS + c * V, kb + j * row_stride + c * V);
    cp_async16(vs + j * HD + c * V, vb + j * row_stride + c * V);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int idx = tid; idx < G * HD; idx += kThreads)
    qs[idx] = to_float(q[head0 * HD + idx]) * scale;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores: thread per (head, row); rows past `rows` or hidden get -inf
  for (int idx = tid; idx < G * chunk; idx += kThreads) {
    const int g = idx / chunk, j = idx % chunk;
    float d = -INFINITY;                               // exp(-inf - m) == 0
    if (j < rows && visible(c0 + j, pos, window)) {
      const T* kr = ks + j * KS;
      const float* qg = qs + g * HD;
      d = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += V) d += dot16(qg + c, kr + c);
    }
    ps[idx] = d;
  }
  __syncthreads();

  // softmax over the chunk: one warp per head; (m, l) go straight out
  for (int g = warp; g < G; g += kThreads / 32) {
    float* pg = ps + g * chunk;
    float mt = -INFINITY;
    for (int j = lane; j < rows; j += 32) mt = fmaxf(mt, pg[j]);
    const float m = fmaxf(warp_max(mt), -1e30f);
    float sum = 0.f;
    for (int j = lane; j < rows; j += 32) {
      const float p = expf(pg[j] - m);
      pg[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      float* mlg = ml + ((head0 + g) * n_split + split) * 2;
      mlg[0] = m;
      mlg[1] = sum;
    }
  }
  __syncthreads();

  // acc[g][d] = sum_j p[g][j] v[j][d], two neighbouring d per thread
  for (int idx = tid; idx < G * HD / 2; idx += kThreads) {
    const int g = idx / (HD / 2), d = 2 * (idx % (HD / 2));
    const float* pg = ps + g * chunk;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int j = 0; j < rows; ++j) {
      const float p = pg[j];
      const float2 vv = load2(vs + j * HD + d);
      a0 = fmaf(p, vv.x, a0);
      a1 = fmaf(p, vv.y, a1);
    }
    *reinterpret_cast<float2*>(part + ((head0 + g) * n_split + split) * HD + d) =
        make_float2(a0, a1);
  }
}

constexpr int kCombineThreads = 128;

// o[b, h] = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30), w_i = exp(m_i - M)
// over the non-empty partials (an empty one, l_i = 0, weighs exactly 0).
// One block per (h, b): the threads read the n_split (m, l) pairs side by
// side, the weights go to shared memory, then thread d sums column d of
// the partials with the loads of four partials in flight at once.
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                            int H, int n_split) {
  extern __shared__ float w[];                  // [n_split], then [32]
  float* red = w + n_split;
  const size_t bh = static_cast<size_t>(blockIdx.y) * H + blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* acc = part + bh * n_split * HD;
  const float* ml = part + static_cast<size_t>(gridDim.y) * H * n_split * HD +
                    bh * n_split * 2;

  float mx = -1e30f;
  for (int i = tid; i < n_split; i += kCombineThreads)
    if (ml[2 * i + 1] > 0.f) mx = fmaxf(mx, ml[2 * i]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float M = red[0];
#pragma unroll
  for (int k = 1; k < kCombineThreads / 32; ++k) M = fmaxf(M, red[k]);

  float lw = 0.f;
  for (int i = tid; i < n_split; i += kCombineThreads) {
    const float li = ml[2 * i + 1];
    const float wi = li > 0.f ? expf(ml[2 * i] - M) : 0.f;
    w[i] = wi;
    lw = fmaf(wi, li, lw);
  }
  lw = warp_sum(lw);
  __syncthreads();                              // red[] read, w[] written
  if (lane == 0) red[warp] = lw;
  __syncthreads();
  float l = 0.f;
#pragma unroll
  for (int k = 0; k < kCombineThreads / 32; ++k) l += red[k];

  for (int d = tid; d < HD; d += kCombineThreads) {
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_split; ++i)
      if (w[i] != 0.f) a = fmaf(w[i], acc[i * HD + d], a);
    from_float(o + bh * HD + d, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* ck, const void* cv, const int* pos,
           void* o, float* part, int B, int L, int H, int KV, int window,
           int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(H / KV, HD, chunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_split = (L + chunk - 1) / chunk;
  flash_decode_split_kernel<T, HD><<<dim3(n_split, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), pos, part, L, H, KV, window, chunk,
      rsqrtf(static_cast<float>(HD)));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_combine_kernel<T, HD>
      <<<dim3(H, B), kCombineThreads, sizeof(float) * (n_split + 32), stream>>>(
          part, static_cast<T*>(o), H, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* ck, const void* cv,
             const int* pos, void* o, float* part, int B, int L, int H, int KV,
             int window, int chunk, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(q, ck, cv, pos, o, part, B, L, H, KV, window, chunk, stream);
    case 64: return launch<T, 64>(q, ck, cv, pos, o, part, B, L, H, KV, window, chunk, stream);
    case 128: return launch<T, 128>(q, ck, cv, pos, o, part, B, L, H, KV, window, chunk, stream);
    case 256: return launch<T, 256>(q, ck, cv, pos, o, part, B, L, H, KV, window, chunk, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// q [B,1,H,hd], ck/cv [B,L,KV,hd], pos int32 [B] on the device, o [B,1,H,hd],
// all contiguous, one dtype (0 = float32, 1 = bfloat16); part fp32 scratch
// of B*H*ceil(L/chunk)*(hd+2) floats; chunk a positive multiple of 16.
// Launches the split kernel, then the combine; returns the first nonzero
// cudaGetLastError() after a launch.
extern "C" int repro_flash_decode(const void* q, const void* ck,
                                  const void* cv, const void* pos, void* o,
                                  void* part, int B, int L, int H, int KV,
                                  int head_dim, int window, int chunk,
                                  int dtype, void* stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || KV > 65535 ||
      H > 65535 || chunk <= 0 || chunk % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* p = static_cast<const int*>(pos);
  float* s = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(head_dim, q, ck, cv, p, o, s, B, L, H, KV,
                                  window, chunk, st);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(head_dim, q, ck, cv, p, o, s, B, L,
                                          H, KV, window, chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
