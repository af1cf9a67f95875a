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
// What bounds it on this card: at prefill lengths, operations (4*S*S_vis*
// H*hd FLOPs against 2*S*(H+2KV)*hd*itemsize bytes), so the products have
// to run on the tensor cores; at the serving shape (B=8, S=512, H=32,
// KV=4, hd=64) the bytes and the bf16 tensor-core peak give about the same
// bound, so K/V tiles must also be read from device memory only once per
// 128 query rows and their loads hidden behind the products.
//
// bf16 (serving) runs flash_attention_bf16_kernel:
//   - work items of (128 query rows, head, batch row), each served by two
//     warpgroups of 64 rows that share its K/V tiles; items are numbered
//     with the longest causal ones first and the H/KV query heads of one
//     KV head side by side, so they meet their K/V in L2;
//   - persistent blocks, as many as fit on the card (two per SM at hd <= 64):
//     block k serves items k, k + grid, ...; all their K/V tiles pass
//     through one ring, and Q is double-buffered, so the next item's loads
//     run while this one finishes (at hd=256, one block per SM, a single Q
//     buffer and a two-stage ring: shared memory holds no more);
//   - S = Q K^T by wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulate),
//     Q and K from shared memory, both K-major as they lie in memory;
//   - the online softmax on the fp32 accumulator fragments in registers:
//     row max of the raw scores by a tree and the 4 threads of a quad,
//     then one FFMA (scale and log2(e) folded) and one ex2.approx per
//     score; the -1e30 start and the exp(m_old - m_new) rescale of O;
//   - O += P V by wgmma m64n64k16 with P converted to bf16 in registers (the
//     accumulator layout of S is the A-fragment layout) and V read MN-major
//     from shared memory (the transpose bit); O stays fp32 in registers and
//     is scaled by 1/max(l, 1e-30) into bf16 at the end.  hd=128 runs two
//     n64 products per step, hd=256 four, hd=32 one n32 product;
//   - K/V tiles of 64 keys go through a three-stage ring in shared memory,
//     loaded by TMA (cp.async.bulk.tensor on a 3-d tensor map over
//     [B, S, heads*hd], 128-byte swizzle, 64-byte for hd=32) with mbarrier
//     completion; its zero fill covers the ragged tail.  Thread 0 issues
//     tile k+2 when tile k is about to be multiplied, once both warpgroups
//     have released its stage (an mbarrier each way, no __syncthreads in
//     the loop).  The tensor maps are encoded on the host per call through
//     cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint (the
//     library links only the runtime);
//   - tiles wholly above the causal diagonal or wholly before the window
//     are neither loaded nor multiplied (per warpgroup: the first one skips
//     the diagonal tile of the second); only edge tiles compute a mask.
// What still bounds it (PERF.md): each warpgroup runs its product, softmax
// and product in turn, and at hd=64 the 16-per-clock ex2 unit needs about
// as long per tile as the tensor cores.  Four warpgroups per SM already
// interleave: neither overlapping one tile's softmax with the last tile's
// P.V product nor a ping-pong of the two warpgroups made it faster.
//
// fp32 (training) runs flash_attention_f32_kernel, on the tensor cores in
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each fp32 operand x is split
// into a TF32 high part hi = rna(x) (the integer form of
// cvt.rna.tf32.f32: add half a TF32 ulp to the bits, clear the low 13) and
// a TF32 remainder lo = rna(x - hi), and a product is lo*hi + hi*lo +
// hi*hi.  The dropped lo*lo term and the rounding of lo leave a relative
// error of about 2^-22 per product, close to fp32's; one TF32 product
// (2^-11) would not give the plain version's results within 1e-4.  The
// tensor cores round their own accumulation toward zero, which chained
// through |S| >> 1 would cost the large-score case its 1e-4: the small
// terms of S get an accumulator of their own, the large ones one per 4
// steps of 8 columns, and each tile's P V starts from 0; they join in fp32
// (round to nearest).  The bound on this route is 3 x 4*S*S_vis*H*hd FLOPs
// at the TF32 peak.
//   - work items of (64 query rows, head, batch row), one warpgroup each,
//     ordered and walked as the bf16 kernel's (longest causal first, the
//     H/KV query heads of one KV head side by side, persistent blocks as
//     many as fit on the card: two per SM at hd <= 64);
//   - Q (double-buffered) and a two-stage ring of 32-key K/V tiles, loaded
//     by TMA with mbarrier completion in boxes of 32 floats (128 bytes,
//     128-byte swizzle);
//   - wgmma takes TF32 operands from shared memory K-major only (the
//     transpose bit is for 16-bit types).  So the warpgroup splits each
//     tile once: Q (once per item) and K in place into their high parts,
//     beside a copy of their low parts, both still as TMA laid them out;
//     V into V^T hi and lo, [hd rows][32 keys], K-major for O += P V.
//     Then fence.proxy.async and one barrier, the only one per tile: a
//     thread that waited for the last tile's products knows they are done
//     (they start only once all four warps issued them), so the next split
//     may overwrite their operands;
//   - S = Q K^T by wgmma m64n32k8 (both operands from shared memory),
//     three per 8 columns of hd; then K and V leave the ring;
//   - the online softmax on S's accumulator fragments as in the bf16
//     kernel (one FFMA and one ex2.approx per score, the -1e30 start, the
//     rescale of O); tiles wholly above the diagonal or before the window
//     are neither split nor multiplied, only edge tiles compute a mask;
//   - O += P V by wgmma m64n64k8 (m64n32k8 at hd=32, two at hd=128) with
//     P's A fragments in registers, taken straight from S's accumulator:
//     it holds keys 2t and 2t+1 of each 8 where an A fragment wants keys t
//     and t+4, so V^T keeps each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7.
// What still bounds it (PERF.md): each warpgroup runs split, barrier,
// product, softmax and product in turn, and only two warpgroups share an
// SM (shared memory); mma.sync m16n8k8 in place of wgmma (each warp
// splitting the fragments it reads) was slower, and a deeper ring at one
// block per SM slower still.
#include <cuda.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------- bf16
// The tensor-core kernel of the serving path (see the note at the top).
namespace tc {

constexpr int kWarpgroups = 2;                  // consumer warpgroups
constexpr int kRows = 64;                       // query rows per warpgroup
constexpr int kBlockQ = kWarpgroups * kRows;    // 128 query rows per block
constexpr int kThreads = 128 * kWarpgroups;     // 256
constexpr int kBK = 64;                         // keys per K/V tile

// Shared-memory layout of a head dimension: rows of `row` bytes (128, or
// 64 for hd = 32) in `blocks` column blocks, swizzled as TMA writes them
// and wgmma reads them (128- or 64-byte swizzle).  Up to hd = 128, Q is
// double-buffered and the K/V ring has three stages; at hd = 256 that
// would be 320 KB against the 227 KB a block may hold, so Q has one
// buffer (the next item's Q loads once this item's last product read it)
// and the ring two stages: 192 KB.
template <int HD>
struct Layout {
  static constexpr int row = HD >= 64 ? 128 : 64;
  static constexpr int cols = row / 2;          // bf16 columns of a block
  static constexpr int blocks = HD / cols;
  static constexpr int n = cols;                // width of one P.V product
  static constexpr int q_block = kBlockQ * row; // bytes of one column block
  static constexpr int kv_block = kBK * row;
  static constexpr int q_bytes = blocks * q_block;
  static constexpr int kv_tile = blocks * kv_block;   // one K or V tile
  static constexpr int q_bufs = HD > 128 ? 1 : 2;
  static constexpr int stages = HD > 128 ? 2 : 3;     // K/V ring depth
  static constexpr int bars = q_bufs * q_bytes + stages * 2 * kv_tile;
  static constexpr int smem = bars + 8 * (2 * stages + 4) + 1024;  // + align
  static constexpr uint64_t swizzle = row == 128 ? 1 : 2;  // descriptor code
  static_assert(smem <= 227 * 1024, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// TMA: a box of the 3-d tensor map at (col, row, batch) into shared memory,
// completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
         "r"(row), "r"(batch) : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory descriptor of a 1024-byte-aligned swizzled tile: start
// address, leading offset (unused: no product reads across column blocks),
// 8 rows between row groups, swizzle code.
template <int HD>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  using Lt = Layout<HD>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * Lt::row) >> 4) << 32) |
         (Lt::swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of a fragment across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A B, A [64 x 16] and B [16 x 64] from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A [64 x 16] bf16 in registers, B [16 x N] MN-major in shared
// memory (the transpose bit); N = 64 or 32
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit; inputs below -126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One work item: a BQ-row query tile of one head and batch row, read in
// key tiles of BK.  Items are numbered longest causal tile first, heads of
// one KV head adjacent.
struct Item {
  int h, b, q0, t_first, n_tiles;
};

template <int BQ = kBlockQ, int BK = kBK>
__device__ __forceinline__ Item item(int w, int S, int H, int B, int causal,
                                     int window) {
  const int n_q = (S + BQ - 1) / BQ;
  Item it;
  it.h = w % H;
  it.b = (w / H) % B;
  it.q0 = (n_q - 1 - w / (H * B)) * BQ;
  // key tiles the query tile can see: causal stops at its last row, a
  // window starts W-1 keys before its first row
  const int k_end = causal ? min(S, it.q0 + BQ) : S;
  const int k_first = (causal && window > 0) ? max(0, it.q0 - window + 1) : 0;
  it.t_first = k_first / BK;
  it.n_tiles = (k_end + BK - 1) / BK - it.t_first;
  return it;
}

// Persistent: block k serves items k, k + gridDim.x, ...; every K/V tile of
// its items passes through one ring, so the next item's loads (and its Q,
// double-buffered) run while this one finishes.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, int B, int S,
                            int H, int KV, int causal, int window,
                            float scale_log2) {
  using Lt = Layout<HD>;
  constexpr int NB = Lt::blocks;
  constexpr int N = Lt::n;                      // columns of one O fragment
  constexpr int QB = Lt::q_bufs, kStages = Lt::stages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;   // Q tiles [QB]
  const uint32_t skv = sq + QB * Lt::q_bytes;   // stage s: K, then V
  const uint32_t full = sq + Lt::bars;          // [kStages] tile landed
  const uint32_t empty = full + 8 * kStages;    // [kStages] tile consumed
  const uint32_t qfull = empty + 8 * kStages;   // [QB] Q landed
  const uint32_t qempty = qfull + 16;           // [QB] Q consumed

  const int total = H * B * ((S + kBlockQ - 1) / kBlockQ);
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int group = H / KV;

  // Thread 0 keeps the ring full, one tile ahead of the tile being
  // multiplied: stream tile g goes to stage g % kStages once both
  // warpgroups have released tile g - kStages.  (pw, pi): the next tile's
  // item and index in it.
  int pw = blockIdx.x, pi = 0, pg = 0;
  Item pit = item(pw, S, H, B, causal, window);
  auto issue_next = [&]() {
    if (pw >= total) return;
    const int s = pg % kStages;
    if (pg >= kStages) mbar_wait(empty + 8 * s, (pg / kStages - 1) & 1);
    const uint32_t ks = skv + s * 2 * Lt::kv_tile, vs = ks + Lt::kv_tile;
    const int k0 = (pit.t_first + pi) * kBK, col0 = (pit.h / group) * HD;
    mbar_expect_tx(full + 8 * s, 2 * Lt::kv_tile);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      tma_load(ks + n * Lt::kv_block, &kmap, full + 8 * s, col0 + n * Lt::cols, k0, pit.b);
      tma_load(vs + n * Lt::kv_block, &vmap, full + 8 * s, col0 + n * Lt::cols, k0, pit.b);
    }
    ++pg;
    if (++pi == pit.n_tiles) {
      pi = 0;
      pw += gridDim.x;
      if (pw < total) pit = item(pw, S, H, B, causal, window);
    }
  };
  auto issue_q = [&](int seq, int w) {          // the block's seq-th item
    const Item it = item(w, S, H, B, causal, window);
    const uint32_t bar = qfull + 8 * (seq % QB);
    mbar_expect_tx(bar, Lt::q_bytes);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      tma_load(sq + (seq % QB) * Lt::q_bytes + n * Lt::q_block, &qmap, bar,
               it.h * HD + n * Lt::cols, it.q0, it.b);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(qfull + 8 * k, 1);
      mbar_init(qempty + 8 * k, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (blockIdx.x < total) issue_q(0, blockIdx.x);
    for (int i = 0; i < kStages - 1; ++i) issue_next();
  }
  __syncthreads();                              // barriers initialised

  int g = 0;                                    // stream index of the tile
  for (int w = blockIdx.x, seq = 0; w < total; w += gridDim.x, ++seq) {
    const Item it = item(w, S, H, B, causal, window);
    if (QB == 2 && tid == 0 && w + gridDim.x < total) {   // the next item's Q
      if (seq >= 1) mbar_wait(qempty + 8 * ((seq + 1) & 1), ((seq - 1) >> 1) & 1);
      issue_q(seq + 1, w + gridDim.x);
    }
    // this thread's two rows of the warpgroup's 64 (the accumulator
    // layout: warp w holds rows 16w..16w+15, lane l rows l/4 and l/4 + 8)
    const int wg_first = it.q0 + wg * kRows, wg_last = wg_first + kRows - 1;
    const int row = wg_first + warp * 16 + lane / 4;
    const int col = 2 * (lane % 4);             // + 8j (+1) within a tile
    const uint32_t qa = sq + (seq % QB) * Lt::q_bytes + wg * kRows * Lt::row;
    float acc[NB][N / 2];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[n][i] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    mbar_wait(qfull + 8 * (seq % QB), (seq / QB) & 1);

    for (int i = 0; i < it.n_tiles; ++i, ++g) {
      if (tid == 0) issue_next();
      const int s = g % kStages;
      mbar_wait(full + 8 * s, (g / kStages) & 1);
      const int k0 = (it.t_first + i) * kBK;
      // tiles wholly above this warpgroup's diagonal or before its window
      const bool live = !causal || (k0 <= wg_last &&
                                    (window <= 0 || k0 + kBK - 1 > wg_first - window));
      if (live) {
        const uint32_t ks = skv + s * 2 * Lt::kv_tile, vs = ks + Lt::kv_tile;
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          constexpr int per_row = Lt::row / 32;     // 16-column steps in a row
          const uint32_t off = (kk % per_row) * 32;   // 16 columns, 32 bytes
          wgmma_ss(sc, desc<HD>(qa + (kk / per_row) * Lt::q_block + off),
                   desc<HD>(ks + (kk / per_row) * Lt::kv_block + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // masked scores become -inf: ex2(-inf) == 0
        if (k0 + kBK > S || (causal && (k0 + kBK - 1 > wg_first ||
                                        (window > 0 && k0 <= wg_last - window)))) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int qp = row + 8 * ((j >> 1) & 1);
            const int kp = k0 + 8 * (j >> 2) + col + (j & 1);
            bool ok = kp < S;
            if (causal) ok = ok && kp <= qp && (window <= 0 || kp > qp - window);
            if (!ok) sc[j] = -INFINITY;
          }
        }
        // row max of the raw scores: a tree over this thread's 16 per row,
        // then over the quad; scale and log2(e) go into one FFMA per score
        float mt[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float t[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            t[u] = fmaxf(sc[4 * u + 2 * r], sc[4 * u + 2 * r + 1]);
#pragma unroll
          for (int half = 4; half > 0; half >>= 1)
#pragma unroll
            for (int u = 0; u < half; ++u) t[u] = fmaxf(t[u], t[u + half]);
          mt[r] = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        }
        float alpha[2], ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], mt[r]);  // finite: m starts at -1e30
          alpha[r] = ex2((m[r] - m_new) * scale_log2);
          ms[r] = m_new * scale_log2;
          m[r] = m_new;
        }
        uint32_t pa[kBK / 16][4];                  // P as bf16 A fragments
        float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}}; // two partial sums a row
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int r = (j >> 1) & 1;
          const float p0 = ex2(fmaf(sc[j], scale_log2, -ms[r]));
          const float p1 = ex2(fmaf(sc[j + 1], scale_log2, -ms[r]));
          ls[r][(j >> 2) & 1] += p0 + p1;
          pa[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)                // this thread's share of l
          l[r] = fmaf(l[r], alpha[r], ls[r][0] + ls[r][1]);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
#pragma unroll
          for (int j = 0; j < N / 2; ++j) acc[n][j] *= alpha[(j >> 1) & 1];
          fence_regs(acc[n]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int n = 0; n < NB; ++n)
            wgmma_rs_t(acc[n], pa[kk],
                       desc<HD>(vs + n * Lt::kv_block + kk * 16 * Lt::row));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
      }
      mbar_arrive(empty + 8 * s);                // this thread is done with s
    }
    mbar_arrive(qempty + 8 * (seq % QB));        // the last product read Q
    if (QB == 1 && tid == 0 && w + gridDim.x < total) {   // the next item's Q
      mbar_wait(qempty, seq & 1);
      issue_q(seq + 1, w + gridDim.x);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    const size_t q_row = static_cast<size_t>(H) * HD;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int c = n * N + 8 * j + col;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = row + 8 * r;
          if (qp >= S) continue;
          *reinterpret_cast<uint32_t*>(o + (static_cast<size_t>(it.b) * S + qp) * q_row +
                                       static_cast<size_t>(it.h) * HD + c) =
              pack_bf16(acc[n][4 * j + 2 * r] * l[r], acc[n][4 * j + 2 * r + 1] * l[r]);
        }
      }
  }
}

// ---------------------------------------------------------------- fp32
// The 3xTF32 tensor-core kernel of the training path (see the note at the
// top).  Its ring, barriers and items work as the bf16 kernel's.
namespace f32 {

constexpr int kBlockQ = 64;                     // query rows: one warpgroup
constexpr int kThreads = 128;
constexpr int kStages = 2;                      // K/V ring depth
constexpr int kBK = 32;                         // keys per K/V tile

// Shared memory, all in rows of 128 bytes with 16-byte chunks swizzled by
// the row (TMA's 128-byte swizzle, which wgmma's descriptors read):
//   Q [2]        TMA's tile in column blocks of 32 floats, split in place
//                to its TF32 high part; Q lo beside it;
//   ring [2]     K (split in place to its high part) and V as TMA wrote
//                them; K lo beside them;
//   V^T hi, lo   [hd rows][32 keys], the keys of each 8 in the order P's
//                A fragments take them (0, 2, 4, 6, 1, 3, 5, 7).
// hd=64: 104 KB, two blocks per SM; hd=128: 208 KB, one.  hd=256 (`big`)
// would need 416 KB: there Q has one buffer, the ring one stage, and V^T
// hi and lo take the places of K and K lo once S = Q K^T is done (224 KB),
// so the next tile loads only after this one's P V; each column block of
// P V then runs alone, so O and one block's P V share the registers.
template <int HD>
struct Layout {
  static constexpr bool big = HD > 128;
  static constexpr int bk = kBK;
  static constexpr int blocks = HD / 32;        // column blocks of Q, K, V
  static constexpr int q_block = kBlockQ * 128; // bytes of one column block
  static constexpr int kv_block = kBK * 128;
  static constexpr int q_bytes = blocks * q_block;
  static constexpr int kv_tile = blocks * kv_block;   // one K or V tile
  static constexpr int q_bufs = big ? 1 : 2;
  static constexpr int stages = big ? 1 : kStages;    // K/V ring depth
  static constexpr int q_lo = q_bufs * q_bytes;
  static constexpr int ring = q_lo + q_bytes;
  static constexpr int k_lo = ring + stages * 2 * kv_tile;
  static constexpr int vt_hi = big ? ring : k_lo + kv_tile;  // HD rows of 32 keys
  static constexpr int vt_lo = big ? k_lo : vt_hi + kv_tile;
  static constexpr int bars = big ? k_lo + kv_tile : vt_lo + kv_tile;
  static constexpr int smem = bars + 8 * (2 * stages + 4) + 1024;  // + align
  static_assert(smem <= 227 * 1024, "shared memory of one block");
};

// x rounded to TF32, nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives, as two integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo in TF32, exact but for lo's rounding (2^-22 relative).  lo
// keeps its low 13 bits: the tensor cores read a TF32 operand's top 19
// bits, so adding half an ulp is its rounding
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ float4 split4(float4& x) {   // x becomes hi
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  x = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                  __uint_as_float(h[2]), __uint_as_float(h[3]));
  return make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                     __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// hi [n4 float4s] split in place, its low parts to lo (same layout)
__device__ __forceinline__ void split_tile(float* hi, float* lo, int n4) {
  for (int c = threadIdx.x; c < n4; c += kThreads) {
    float4 x = reinterpret_cast<float4*>(hi)[c];
    reinterpret_cast<float4*>(lo)[c] = split4(x);
    reinterpret_cast<float4*>(hi)[c] = x;
  }
}

// generic-proxy writes to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// descriptor of a 1024-byte-aligned, 128-byte-swizzled K-major tile
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= A B, A [64 x 8] and B [8 x 32] TF32 from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, A [64 x 8] TF32 in registers, B [8 x N] from shared memory;
// N = 64 or 32
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Persistent: block k serves items k, k + gridDim.x, ...; one warpgroup
// per item of 64 query rows.  In an accumulator fragment, warp w holds
// rows 16w..16w+15 and lane l rows l/4 and l/4 + 8, columns 2(l%4) and
// 2(l%4) + 1 of each 8.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           float* __restrict__ o, int B, int S, int H, int KV,
                           int causal, int window, float scale_log2) {
  using Lt = Layout<HD>;
  constexpr int NB = Lt::blocks;
  constexpr int NO = HD > 64 ? 64 : HD;         // columns of one P V product
  constexpr int NP = HD / NO;                   // P V products per 8 keys
  constexpr int KS = kBK / 8;                   // 8-key steps of a tile
  constexpr bool BIG = Lt::big;
  constexpr int QB = Lt::q_bufs, NSTAGE = Lt::stages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sq = (base + 1023) & ~1023u;   // everything below from here
  const uint32_t full = sq + Lt::bars;          // [NSTAGE] tile landed
  const uint32_t empty = full + 8 * NSTAGE;     // [NSTAGE] tile consumed
  const uint32_t qfull = empty + 8 * NSTAGE;    // [QB] Q landed
  const uint32_t qempty = qfull + 16;           // [QB] Q consumed
  float* const sf = reinterpret_cast<float*>(smem_raw + (sq - base));

  const int total = H * B * ((S + kBlockQ - 1) / kBlockQ);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = H / KV;

  // Thread 0 keeps the ring one tile ahead of the tile being multiplied,
  // as in the bf16 kernel: stream tile g goes to stage g % NSTAGE once
  // every thread has released tile g - NSTAGE.
  int pw = blockIdx.x, pi = 0, pg = 0;
  Item pit = item<kBlockQ, kBK>(pw, S, H, B, causal, window);
  auto issue_next = [&]() {
    if (pw >= total) return;
    const int s = pg % NSTAGE;
    if (pg >= NSTAGE) mbar_wait(empty + 8 * s, (pg / NSTAGE - 1) & 1);
    const uint32_t ks = sq + Lt::ring + s * 2 * Lt::kv_tile, vs = ks + Lt::kv_tile;
    const int k0 = (pit.t_first + pi) * kBK, col0 = (pit.h / group) * HD;
    mbar_expect_tx(full + 8 * s, 2 * Lt::kv_tile);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      tma_load(ks + n * Lt::kv_block, &kmap, full + 8 * s, col0 + 32 * n, k0, pit.b);
      tma_load(vs + n * Lt::kv_block, &vmap, full + 8 * s, col0 + 32 * n, k0, pit.b);
    }
    ++pg;
    if (++pi == pit.n_tiles) {
      pi = 0;
      pw += gridDim.x;
      if (pw < total) pit = item<kBlockQ, kBK>(pw, S, H, B, causal, window);
    }
  };
  auto issue_q = [&](int seq, int w) {          // the block's seq-th item
    const Item it = item<kBlockQ, kBK>(w, S, H, B, causal, window);
    const uint32_t bar = qfull + 8 * (seq % QB);
    mbar_expect_tx(bar, Lt::q_bytes);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      tma_load(sq + (seq % QB) * Lt::q_bytes + n * Lt::q_block, &qmap, bar,
               it.h * HD + 32 * n, it.q0, it.b);
  };
  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(qfull + 8 * k, 1);
      mbar_init(qempty + 8 * k, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (blockIdx.x < total) issue_q(0, blockIdx.x);
    for (int i = 0; i < NSTAGE - 1; ++i) issue_next();
  }
  __syncthreads();                              // barriers initialised

  int g = 0;                                    // stream index of the tile
  for (int w = blockIdx.x, seq = 0; w < total; w += gridDim.x, ++seq) {
    const Item it = item<kBlockQ, kBK>(w, S, H, B, causal, window);
    if (QB == 2 && tid == 0 && w + gridDim.x < total) {   // the next item's Q
      if (seq >= 1) mbar_wait(qempty + 8 * ((seq + 1) & 1), ((seq - 1) >> 1) & 1);
      issue_q(seq + 1, w + gridDim.x);
    }
    const int wg_first = it.q0, wg_last = wg_first + kBlockQ - 1;
    const int row = wg_first + warp * 16 + lane / 4;   // and row + 8
    const int col = 2 * (lane % 4);                    // + 8j (+1)
    const uint32_t qh = sq + (seq % QB) * Lt::q_bytes, ql = sq + Lt::q_lo;
    float acc[NP][NO / 2];
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int i = 0; i < NO / 2; ++i) acc[n][i] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    // Q split once per item.  The last item's products are complete: this
    // thread waited for them, and they ran only once every warp issued them
    mbar_wait(qfull + 8 * (seq % QB), (seq / QB) & 1);
    split_tile(sf + (qh - sq) / 4, sf + Lt::q_lo / 4, Lt::q_bytes / 16);
    fence_async_smem();
    __syncthreads();

    for (int i = 0; i < it.n_tiles; ++i, ++g) {
      if (tid == 0) issue_next();
      const int s = g % NSTAGE;
      mbar_wait(full + 8 * s, (g / NSTAGE) & 1);
      const int k0 = (it.t_first + i) * kBK;
      const uint32_t kh = sq + Lt::ring + s * 2 * Lt::kv_tile;
      // tiles wholly above the diagonal or before the window
      const bool live = !causal || (k0 <= wg_last &&
                                    (window <= 0 || k0 + kBK - 1 > wg_first - window));
      if (!live) {
        mbar_arrive(empty + 8 * s);
        continue;
      }
      // K split in place and its low parts to K lo; V split into V^T, its
      // keys permuted (at hd=256 once S is done: V^T lands on K).  The
      // last tile's products are complete, as for Q
      split_tile(sf + (kh - sq) / 4, sf + Lt::k_lo / 4, Lt::kv_tile / 16);
      const auto split_v = [&]() {
        const float4* vr = reinterpret_cast<const float4*>(sf + (kh - sq) / 4 + Lt::kv_tile / 4);
        float* vth = sf + Lt::vt_hi / 4;
        float* vtl = sf + Lt::vt_lo / 4;
        for (int c = tid; c < Lt::kv_tile / 16; c += kThreads) {
          float4 x = vr[c];
          const float4 lo = split4(x);
          const int j = (c / 8) % kBK;                       // key in the tile
          const int d0 = (c / (8 * kBK)) * 32 + (((c % 8) ^ (j & 7)) << 2);
          const int p = (j & 24) | ((j & 7) >> 1) | ((j & 1) << 2);
          const float xh[4] = {x.x, x.y, x.z, x.w}, xl[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = d0 + e;
            const int at = d * 32 + ((((p >> 2) ^ d) & 7) << 2) + (p & 3);
            vth[at] = xh[e];
            vtl[at] = xl[e];
          }
        }
      };
      if (!BIG) split_v();
      fence_async_smem();
      __syncthreads();

      // S = Q K^T in 3xTF32: the small terms in one accumulator, the
      // large ones in NS, each a chain of 4 steps of 8 columns (8 at
      // hd=128, where registers allow no more)
      constexpr int NS = HD > 64 ? 2 : HD / 32;
      float sb[NS][16], ss[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const uint32_t qoff = (kk / 4) * Lt::q_block + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * Lt::kv_block + (kk % 4) * 32;
        constexpr int per = HD / 8 / NS;          // steps per large chain
        wgmma_ss(ss, desc(ql + qoff), desc(kh + koff), kk > 0);
        wgmma_ss(ss, desc(qh + qoff), desc(sq + Lt::k_lo + koff), 1);
        wgmma_ss(sb[kk / per], desc(qh + qoff), desc(kh + koff), kk % per > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ss);
#pragma unroll
      for (int c = 0; c < NS; ++c) fence_regs(sb[c]);
      if (BIG) {                                 // every warp's S is done
        __syncthreads();
        split_v();
        fence_async_smem();
        __syncthreads();
      } else {
        mbar_arrive(empty + 8 * s);              // K and V are out of the ring
      }
      float sc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[j] = ss[j];
#pragma unroll
        for (int c = 0; c < NS; ++c) sc[j] += sb[c][j];
      }

      // masked scores become -inf: ex2(-inf) == 0
      if (k0 + kBK > S || (causal && (k0 + kBK - 1 > wg_first ||
                                      (window > 0 && k0 <= wg_last - window)))) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int qp = row + 8 * ((j >> 1) & 1);
          const int kp = k0 + 8 * (j >> 2) + col + (j & 1);
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp && (window <= 0 || kp > qp - window);
          if (!ok) sc[j] = -INFINITY;
        }
      }
      // row max over this thread's 8 per row and its quad; scale and
      // log2(e) go into one FFMA per score
      float alpha[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mt = fmaxf(mt, fmaxf(sc[4 * u + 2 * r], sc[4 * u + 2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[r], mt);    // finite: m starts at -1e30
        alpha[r] = ex2((m[r] - m_new) * scale_log2);
        ms[r] = m_new * scale_log2;
        m[r] = m_new;
      }
      float ls[2] = {0.f, 0.f};
      uint32_t ph[KS][4], pl[KS][4];            // P's A fragments
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = ex2(fmaf(sc[j], scale_log2, -ms[(j >> 1) & 1]));
        ls[(j >> 1) & 1] += p;
        // keys 2t, 2t+1 of each 8 are A columns t, t+4: (j & 1) picks the
        // column half, (j >> 1) & 1 the row half
        const int a = ((j >> 1) & 1) | ((j & 1) << 1);
        split(p, ph[j >> 2][a], pl[j >> 2][a]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], ls[r]);

      // O = alpha O + P V: the tile's P V from 0, in 3xTF32 (at hd=256
      // one column block at a time)
      constexpr int NPV = BIG ? 1 : NP;          // blocks of P V in flight
#pragma unroll
      for (int n0 = 0; n0 < NP; n0 += NPV) {
        float pv[NPV][NO / 2];
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KS; ++j)
#pragma unroll
          for (int n = 0; n < NPV; ++n) {
            const uint32_t voff = (n0 + n) * NO * 128 + j * 32;
            wgmma_rs(pv[n], pl[j], desc(sq + Lt::vt_hi + voff), j > 0);
            wgmma_rs(pv[n], ph[j], desc(sq + Lt::vt_lo + voff), 1);
            wgmma_rs(pv[n], ph[j], desc(sq + Lt::vt_hi + voff), 1);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int n = 0; n < NPV; ++n) {
          fence_regs(pv[n]);
#pragma unroll
          for (int i = 0; i < NO / 2; ++i)
            acc[n0 + n][i] = fmaf(acc[n0 + n][i], alpha[(i >> 1) & 1], pv[n][i]);
        }
      }
      if (BIG) mbar_arrive(empty + 8 * s);       // V^T (over K) is read
    }
    mbar_arrive(qempty + 8 * (seq % QB));        // the last product read Q
    if (QB == 1 && tid == 0 && w + gridDim.x < total) {   // the next item's Q
      mbar_wait(qempty, seq & 1);
      issue_q(seq + 1, w + gridDim.x);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    const size_t q_row = static_cast<size_t>(H) * HD;
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int j = 0; j < NO / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = row + 8 * r;
          if (qp >= S) continue;
          *reinterpret_cast<float2*>(o + (static_cast<size_t>(it.b) * S + qp) * q_row +
                                     static_cast<size_t>(it.h) * HD + n * NO + 8 * j + col) =
              make_float2(acc[n][4 * j + 2 * r] * l[r], acc[n][4 * j + 2 * r + 1] * l[r]);
        }
  }
}

}  // namespace f32

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (the
// library links only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// [B, S, width] as a 3-d tensor map read in boxes of `cols` columns x
// `rows` rows of one batch row; rows past S read as zeros
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                const void* base, int width, int S, int B, int cols, int rows,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t w = static_cast<cuuint64_t>(width);
  const cuuint64_t dims[3] = {w, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {elem_bytes * w, elem_bytes * w * S};  // bytes
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [B, S, heads * hd] bf16 in the layout of Layout<HD>
template <int HD>
bool tensor_map(CUtensorMap* map, const void* base, int heads, int S, int B,
                int rows) {
  using Lt = Layout<HD>;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                    heads * HD, S, B, Lt::cols, rows,
                    Lt::row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int causal, int window, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!tensor_map<HD>(&qmap, q, H, S, B, kBlockQ) ||
      !tensor_map<HD>(&kmap, k, KV, S, B, kBK) ||
      !tensor_map<HD>(&vmap, v, KV, S, B, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Layout<HD>::smem;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many blocks as fit on the card at once, at most one per item
  static const int resident = [] {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_attention_bf16_kernel<HD>, kThreads, Layout<HD>::smem);
    return std::max(1, sms * per_sm);
  }();
  const long items = static_cast<long>(H) * B * ((S + kBlockQ - 1) / kBlockQ);
  const int grid = static_cast<int>(std::min<long>(items, resident));
  flash_attention_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), B, S, H, KV, causal,
      window, 1.4426950408889634f * rsqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int causal, int window,
               cudaStream_t stream) {
  using Lt = f32::Layout<HD>;
  const auto map = [&](CUtensorMap* m, const void* base, int heads, int rows) {
    return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, heads * HD,
                      S, B, 32, rows, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  CUtensorMap qmap, kmap, vmap;
  if (!map(&qmap, q, H, f32::kBlockQ) || !map(&kmap, k, KV, Lt::bk) ||
      !map(&vmap, v, KV, Lt::bk))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      f32::flash_attention_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many blocks as fit on the card at once, at most one per item
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, f32::flash_attention_f32_kernel<HD>, f32::kThreads, Lt::smem);
    return std::max(1, n);
  }();
  const long items = static_cast<long>(H) * B *
                     ((S + f32::kBlockQ - 1) / f32::kBlockQ);
  const int grid = static_cast<int>(
      std::min<long>(items, static_cast<long>(device_sms()) * per_sm));
  f32::flash_attention_f32_kernel<HD><<<grid, f32::kThreads, Lt::smem, stream>>>(
      qmap, kmap, vmap, static_cast<float*>(o), B, S, H, KV, causal, window,
      1.4426950408889634f * rsqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int dispatch_f32(int head_dim, const void* q, const void* k, const void* v,
                 void* o, int B, int S, int H, int KV, int causal, int window,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 32: return tc::launch_f32<32>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 64: return tc::launch_f32<64>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 128: return tc::launch_f32<128>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 256: return tc::launch_f32<256>(q, k, v, o, B, S, H, KV, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(int head_dim, const void* q, const void* k, const void* v,
                  void* o, int B, int S, int H, int KV, int causal, int window,
                  cudaStream_t stream) {
  switch (head_dim) {
    case 32: return tc::launch<32>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 64: return tc::launch<64>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 128: return tc::launch<128>(q, k, v, o, B, S, H, KV, causal, window, stream);
    case 256: return tc::launch<256>(q, k, v, o, B, S, H, KV, causal, window, stream);
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
    return repro::dispatch_f32(head_dim, q, k, v, o, B, S, H, KV, causal,
                               window, st);
  if (dtype == repro::kBFloat16)
    return repro::dispatch_bf16(head_dim, q, k, v, o, B, S, H, KV, causal,
                                window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
