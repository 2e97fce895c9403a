// Causal GQA prefill for Hopper (sm_90a), one kernel template with four
// instances by KV source: K5 (over a bf16 pool's history), K5q (int8 and fp8
// pools), and fresh prefill with no history and no pool (KV_NONE), which is
// K2 and K8.
//
// Replaces the TPU kernels of lite_llama_tpu/ops/attention_prefill.py:
// - K5 / K5q: flash_prefill_chunked -> _prefill_kernel with has_history=True
//   (bf16 pools, and the int8 branch, quantized=True); fp8 pools are the JAX
//   dispatcher's XLA reference (lite_llama_tpu/ops/__init__.py:96-117), the
//   same function.
// - K2: flash_prefill -> _flash_prefill_impl / _prefill_kernel with
//   has_history=False, head dims 64 and 128.
// - K8: flash_prefill -> _flash_prefill_vmem / _prefill_kernel_vmem, the
//   same function for head dims the TPU cannot pack into 128 lanes (there
//   the whole key stream of a head sits in VMEM, capped near S ~ 8k; here it
//   streams like the rest and has no cap).
// Fresh prefill is chunked prefill with start_pos = 0, chunk_lens = seq_lens
// and no pool: the KV_NONE instance compiles the history out. Its q tiles
// wholly past a request's length, and its rows past it, are padding that no
// caller reads: they are neither computed nor stored.
//
// Chunk query row s of request b attends the pool history [0, start_pos[b])
// through table_rows[b] (no mask there), then the chunk's own keys p <= s,
// p < chunk_lens[b]. One online-softmax state spans both phases. Pad rows
// (s >= chunk_lens[b]) attend the whole chunk. A request with no history and
// an empty chunk writes out = 0, m = -1e30, l = 0; chunk_lens = 0 with a
// history is a walk over the history only. With m/l pointers the kernel
// also writes each query row's state (exp2 domain) for a later LSE combine.
// q is scaled by sm_scale*log2(e) and rounded to bf16; P is rounded to bf16
// before PV and l sums the unrounded P. int8 history is
// bf16(float(k) * float(scale)), rounded once; fp8 e4m3 converts exactly.
// Any even head dim from 16 to 128, at most 8 query heads per kv head.
//
// What bounds it: tensor-core operations for long chunks, about
// 4 * Nq * D * sum_b(chunk_b * hist_b + chunk_b^2 / 2) FLOPs against 989
// TFLOP/s in bf16 (main shape, 8 x 512 rows over 512 tokens: 38.7 GFLOP,
// 0.039 ms); the bytes of the history K/V, q, k, v and out against 3.35 TB/s
// for short chunks (a prefix hit, 8 rows over 256 tokens: 16.9 MB, 0.005 ms).
// Fresh prefill is the same count with no history: operations for long
// prompts (Llama-3.2-3B, lens 2048 / 1541 / 37 / 1: 40.4 GFLOP, 0.041 ms),
// bytes of q, k, v and out for the short batch prompts (12 x 25 tokens:
// 4.9 MB, 0.0015 ms), where one tile per item leaves it latency-bound.
//
// Design. A work item is one (request, kv head, q tile). A block has three
// warpgroups: a producer that fills a ring of K/V tiles in shared memory and
// two consumers of 64 rows each. With a history the grid is persistent, one
// block per SM taking one item in each pass over the grid (passes alternate
// in direction, see nth_item), and the producer runs on into the block's
// next item while the consumers finish one, so no SM waits for a block to
// start. Fresh prefill launches one block per item instead: its ragged
// batches hold many empty padding items, which the static passes spread
// unevenly (PERF.md). The numbers name what held the first kernels back
// (the v1 template that K2 / K8 ran until they became this kernel's KV_NONE
// instance, and K5 with it before):
// 1. Packed GQA rows (it had 16 * 8/G positions x G heads per block, 96 rows
//    at G 3). The block's BM = 128 rows are (position, query head) pairs of
//    the G heads that share the kv head, flat index f = position * G + g over
//    the chunk, so every K/V tile serves 128 rows whatever G is. The causal
//    and length masks use each row's own position; a consumer skips a chunk
//    tile above its last position and the mask of a tile every key of which
//    its rows see. Items are numbered with the longest q tiles of every
//    (request, kv head) first, which shortens the tail of the last wave.
// 2. An asynchronous ring (it loaded each tile synchronously between two
//    block barriers): STAGES tiles of BK = 64 keys x DP in dynamic shared
//    memory. The producer fills a stage with cp.async (16-byte copies, or 8 /
//    4 where D's alignment forbids 16, D = 100; zeros past the limit and in
//    lanes D..DP-1) and hands it over through an mbarrier that the copies
//    themselves complete (cp.async.mbarrier.arrive); the consumers return it
//    through a second one. After the start no barrier spans the block, so
//    the producer runs up to STAGES tiles ahead. History and chunk tiles of
//    all the block's items are one stream of tiles. bf16 rows (the chunk's,
//    and a bf16 pool's) are copied through L1 (cp.async.ca), which cut the
//    load path's own time at the main shape by a quarter; 1-byte pool rows
//    bypass it (.cg), which is faster for them (PERF.md).
// 3. No per-element fragment loads (it built each PV B fragment from four
//    2-byte shared loads): the copies write K and V in wgmma's no-swizzle
//    8 x 8 core-matrix layout, K K-major and V MN-major, and the tensor cores
//    read both through matrix descriptors. (The step before this design,
//    ldmatrix.x4 / .x4.trans fragments for mma.sync, is measured in PERF.md.)
// 4. wgmma (it ran mma.sync): m64n64k16 for S = Q K^T with the scaled bf16 q
//    rows in shared memory, and m64nNk16 over N = 64 / 32 / 16 slices of DP
//    for O += P V with P rounded to bf16 in registers (the accumulator layout
//    of S is the A-register layout of PV). The two consumers take turns to
//    issue their QK products (named barriers), so one's softmax runs under
//    the other's products.
// 5. The page table is read once per page of a tile (it looked a row up for
//    every 16-byte load): one producer thread per page reads the entry, one
//    per key forms the key's pool row, and the copies read those rows. Any
//    page size, page ids in any order.
// 6. 1-byte pools (it dequantized each element on its way into shared
//    memory): raw int8 / fp8 rows (half of bf16's bytes) and each key's K and
//    V scale words (the aligned bf16 pair of the [L, T, 128] slab holding
//    lanes h and 64 + h) land in a two-slot raw ring; the producer turns a
//    landed raw tile into the stage's bf16 tiles while the next raw tile is
//    in flight. An int8 value becomes a float through the float's mantissa
//    (a byte permute and a subtraction, no conversion instruction), and two
//    of them meet their scale in one bf16x2 product.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"  // smem_u32, mbarriers

namespace {

// Where the history comes from: a bf16, int8 or fp8 pool, or nowhere (fresh
// prefill, K2 / K8).
enum KvType { KV_BF16 = 0, KV_INT8 = 1, KV_FP8 = 2, KV_NONE = 3 };
__host__ __device__ constexpr bool one_byte_kv(int kv) { return kv == KV_INT8 || kv == KV_FP8; }

constexpr int BK = 64;             // keys per tile
constexpr int WARPGROUPS = 2;      // consumers, 64 packed rows each
constexpr int BM = 64 * WARPGROUPS;
constexpr int CONSUMERS = 128 * WARPGROUPS;
constexpr int PRODUCERS = 128;      // one warpgroup fills the ring
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int STAGES = 4;          // ring stages
constexpr int MAX_G = 8;
constexpr int MAX_D = 128;
constexpr int SCALE_LANES = 128;  // the int8 pool's merged scale slab
constexpr float NEG = -1e30f;

// Shared-memory layout of one instance. A K or V tile is BK x DP bf16 in
// wgmma's canonical no-swizzle layout of 8 x 8 core matrices (8 rows of 16
// contiguous bytes): K K-major, core matrix (key block n/8, dim block d/8)
// at (n/8) * 16 DP + (d/8) * 128 bytes; V MN-major, core matrix (dim block
// d/8, key block n/8) at (d/8) * 16 BK + (n/8) * 128 bytes. The q rows use
// K's layout. A stage is a K tile and a V tile. A 1-byte pool adds two raw
// slots (rows of RS bytes) and their scale words.
template <int DP>
struct Layout {
  static constexpr int RS = DP + 16;       // raw 1-byte row stride (bytes)
  static constexpr int TILE = BK * DP * 2; // bytes of one bf16 K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int QTILE = BM * DP * 2;  // the block's scaled q rows
  static constexpr int RAW = 2 * BK * RS;  // one raw 1-byte K + V tile
  static constexpr int SCALES = BK * 2 * 4;  // K and V scale words per key
  // ring | q | full, empty barriers | page ids | pool rows | 1-byte pools:
  // 2 scale slots, 2 raw slots
  static constexpr int OFF_Q = STAGES * STAGE;
  static constexpr int OFF_BAR = OFF_Q + QTILE;
  static constexpr int OFF_PAGE = OFF_BAR + 2 * STAGES * 8;
  static constexpr int OFF_ROWS = OFF_PAGE + BK * 4;
  static constexpr int OFF_SCL = OFF_ROWS + BK * 4;
  static constexpr int OFF_RAW = OFF_SCL + 2 * SCALES;
  static constexpr int bytes(bool one_byte) { return one_byte ? OFF_RAW + 2 * RAW : OFF_SCL; }
  // Byte offset of the 16-byte piece p (values 8p..8p+7) of key (or q row) n.
  static __device__ __forceinline__ int k_off(int n, int p) {
    return (n >> 3) * (16 * DP) + p * 128 + (n & 7) * 16;
  }
  static __device__ __forceinline__ int v_off(int n, int p) {
    return p * (16 * BK) + (n >> 3) * 128 + (n & 7) * 16;
  }
};

struct Args {
  const __nv_bfloat16* q;       // [B, S, Nq, D]
  const __nv_bfloat16* k;       // [B, S, Hkv, D]
  const __nv_bfloat16* v;       // [B, S, Hkv, D]
  const int* chunk_lens;        // [B] (fresh prefill: seq_lens)
  // The history, null in fresh prefill:
  const int* start_pos;         // [B]
  const uint8_t* pages;         // [L, 2, T, Hkv*D] of bf16, int8 or fp8
  const __nv_bfloat16* scales;  // [L, T, 128] (int8 pools only)
  const int* table;             // [B, ppr]
  __nv_bfloat16* out;           // [B, S, Nq, D]
  float* m_out;                 // [B, S, Nq] or null
  float* l_out;                 // [B, S, Nq] or null
  int B, S, Nq, Hkv, D;
  int n_qt;                     // q tiles of BM packed rows per (request, kv head)
  int ub_hist, ub_chunk, ub_q;  // bytes per copy or load: pool rows, chunk rows, q rows
  float qscale;
  long long T;
  int layer, ps, ppr;
};


// UB bytes from global to shared memory; zeros when !valid. 16, 8 and 4
// bytes go by cp.async; 2 bytes (a 1-byte pool at D = 2 mod 4) through a
// register.
template <int UB, bool L1 = false>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  if constexpr (UB == 2) {
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  } else if constexpr (UB == 16) {
    if (L1)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                   "l"(src), "r"(valid ? 16 : 0)
                   : "memory");
    else
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                   "l"(src), "r"(valid ? 16 : 0)
                   : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(UB), "r"(valid ? UB : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving an accumulator across a wgmma boundary.
__device__ __forceinline__ void fence_reg(float& x) { asm volatile("" : "+f"(x)::"memory"); }

// A no-swizzle shared-memory matrix descriptor: start, leading and stride
// byte offsets (all multiples of 16).
__device__ __forceinline__ uint64_t mat_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// m64nNk16, bf16 in, fp32 accumulate: A (64 x 16) from registers in the
// mma.sync fragment layout of each warp's 16 rows, B from shared memory;
// TRANS_B 0 for a K-major B, 1 for an MN-major one.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "%14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, "
      "%22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, "
      "%38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
}

// m64nNk16 with A (64 x 16, K-major) and B (K-major) from shared memory;
// ACC 0 overwrites d (the first k step), 1 accumulates into it.
template <int ACC>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t adesc, uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(ACC));
}

// 2^x by the SFU's approximation (relative error ~2^-22, subnormal results
// flushed to zero): P is rounded to bf16 (2^-8) right after.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The product of two bf16x2 registers, each half rounded once to bf16.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two floats -> one bf16x2 register; the first goes to the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Ping-pong: consumer warpgroup w issues its QK product after the other
// one has issued its own (named barriers 4 + w, both warpgroups counted).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(4 + wg), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(4 + (wg ^ 1)), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
}

// History tile into shared memory from the producer warpgroup (thread pt):
// bf16 into the ring stage (core-matrix layout), or raw 1-byte rows (stride
// RS) plus, for int8, each key's K and V scale words. Keys past hist (row
// -1) and lanes D..DP-1 are zeros. Eight consecutive threads take one piece
// of eight consecutive keys: one core-matrix row each.
template <int DP, int KV, int UB>
__device__ __forceinline__ void load_history(int pt, uint8_t* dst, uint32_t* scl, const int* rows,
                                             const uint8_t* kpool, const uint8_t* vpool,
                                             const __nv_bfloat16* sbase, int h, int D, int Hkv) {
  using L = Layout<DP>;
  constexpr int EB = KV == KV_BF16 ? 2 : 1;
  constexpr int NP = DP * EB / UB;  // copies per key row
  const long long rb = (long long)EB * Hkv * D;  // bytes per pool row
  for (int u = pt; u < BK * NP; u += PRODUCERS) {
    const int n = ((u >> 3) / NP) * 8 + (u & 7);
    const int p = (u >> 3) % NP;
    const int cb = p * UB;  // byte offset in the row
    const int row = rows[n];
    const bool ok = row >= 0 && cb < EB * D;
    const long long src = ok ? row * rb + cb : 0;
    uint8_t *dK, *dV;
    if constexpr (KV == KV_BF16) {
      dK = dst + L::k_off(n, cb >> 4) + (cb & 15);
      dV = dst + L::TILE + L::v_off(n, cb >> 4) + (cb & 15);
    } else {
      dK = dst + n * L::RS + cb;
      dV = dK + BK * L::RS;
    }
    copy_async<UB, KV == KV_BF16>(dK, kpool + src, ok);
    copy_async<UB, KV == KV_BF16>(dV, vpool + src, ok);
    if constexpr (KV == KV_INT8) {
      if (p == 0) {  // the aligned bf16 pairs holding lanes h and 64 + h
        const __nv_bfloat16* s = sbase + (long long)max(row, 0) * SCALE_LANES + (h & ~1);
        copy_async<4>(scl + 2 * n, s, row >= 0);
        copy_async<4>(scl + 2 * n + 1, s + SCALE_LANES / 2, row >= 0);
      }
    }
  }
}

// Chunk tile j0 of the request's own bf16 K/V into a ring stage
// (core-matrix layout); keys at or past kv_hi and lanes D..DP-1 are zeros.
template <int DP, int UB>
__device__ __forceinline__ void load_chunk(int pt, uint8_t* stage, const __nv_bfloat16* kb,
                                           const __nv_bfloat16* vb, long long ks, int j0,
                                           int kv_hi, int D) {
  using L = Layout<DP>;
  constexpr int NP = DP * 2 / UB;
  for (int u = pt; u < BK * NP; u += PRODUCERS) {
    const int n = ((u >> 3) / NP) * 8 + (u & 7);
    const int p = (u >> 3) % NP;
    const int cb = p * UB;
    const int pos = j0 + n;
    const bool ok = pos < kv_hi && cb < 2 * D;
    const long long src = ok ? (long long)pos * ks * 2 + cb : 0;
    copy_async<UB, true>(stage + L::k_off(n, cb >> 4) + (cb & 15),
                         reinterpret_cast<const uint8_t*>(kb) + src, ok);
    copy_async<UB, true>(stage + L::TILE + L::v_off(n, cb >> 4) + (cb & 15),
                         reinterpret_cast<const uint8_t*>(vb) + src, ok);
  }
}

// A landed raw 1-byte tile (rows, scale words) as the bf16 ring stage the
// wgmma reads: int8 as bf16(float(x) * float(scale)), exact in fp32 and
// rounded once; fp8 e4m3 converts exactly. Zero bytes (padding) give zeros.
template <int DP, int KV>
__device__ __forceinline__ void dequant_tile(int pt, uint8_t* dst, const uint8_t* raw,
                                             const uint32_t* scl, int h) {
  using L = Layout<DP>;
  constexpr int NCH = DP / 16;  // 16-value pieces per row
  for (int idx = pt; idx < 2 * BK * NCH; idx += PRODUCERS) {
    const int kv = idx / (BK * NCH);  // 0: K, 1: V
    const int rest = idx % (BK * NCH);
    const int n = ((rest >> 3) / NCH) * 8 + (rest & 7);
    const int ch = (rest >> 3) % NCH;  // values 16 ch .. 16 ch + 15
    const uint4 bytes = *reinterpret_cast<const uint4*>(raw + (kv * BK + n) * L::RS + 16 * ch);
    uint32_t sc2 = 0u;  // the key's scale in both halves of a bf16x2
    if constexpr (KV == KV_INT8) {
      const uint32_t w = scl[2 * n + kv];
      sc2 = __byte_perm(w, 0u, h & 1 ? 0x3232 : 0x1010);
    }
    const uint32_t src[4] = {bytes.x, bytes.y, bytes.z, bytes.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (KV == KV_INT8) {
        // x + 2^23 + 128 assembled in a float's mantissa, minus the offset,
        // is x with no conversion instruction; a pair of them is exact in
        // bf16, and its bf16x2 product with the scale is rounded once.
        const uint32_t wx = src[i >> 1] ^ 0x80808080u;
        const int b0 = 2 * (i & 1);  // the pair's first byte
        const float f0 = __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + b0)) - 8388736.f;
        const float f1 = __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7541 + b0)) - 8388736.f;
        o[i] = mul_bf16x2(pack2(f0, f1), sc2);
      } else {
        // Two e4m3 values at once to fp16, then fp32: both steps exact.
        const __half2 hv(__nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(src[i >> 1] >> (16 * (i & 1))), __NV_E4M3));
        const float2 f = __half22float2(hv);
        o[i] = pack2(f.x, f.y);
      }
    }
    uint8_t* base = dst + kv * L::TILE;
    const int o0 = kv ? L::v_off(n, 2 * ch) : L::k_off(n, 2 * ch);
    const int o1 = kv ? L::v_off(n, 2 * ch + 1) : L::k_off(n, 2 * ch + 1);
    *reinterpret_cast<uint4*>(base + o0) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(base + o1) = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// O[:, n0 : n0 + N] += P V over 16 keys: the largest of 64, 32, 16 first.
template <int DP, int N0>
__device__ __forceinline__ void pv_slices(float (&o)[DP / 8][4], const uint32_t (&pa)[4],
                                          uint32_t sV) {
  constexpr int LEFT = DP - N0;
  const uint64_t d = mat_desc(sV + (N0 / 8) * 16 * BK, 128, 16 * BK);
  if constexpr (LEFT >= 64) {
    wgmma_n64<1>(&o[N0 / 8][0], pa, d);
    pv_slices<DP, N0 + 64>(o, pa, sV);
  } else if constexpr (LEFT >= 32) {
    wgmma_n32<1>(&o[N0 / 8][0], pa, d);
    pv_slices<DP, N0 + 32>(o, pa, sV);
  } else if constexpr (LEFT >= 16) {
    wgmma_n16<1>(&o[N0 / 8][0], pa, d);
    pv_slices<DP, N0 + 16>(o, pa, sV);
  }
}

// One consumer warpgroup's 64 packed rows (q in shared memory at sQ) against
// one BK-key tile: S = Q K^T by wgmma, mask, online-softmax update, O += P V
// by wgmma. Each thread holds the mma.sync fragments of its warp's 16 rows
// (the wgmma register layouts are those of mma.sync, warp by warp). CAUSAL:
// key j0 + i is visible to a row at position p iff it is <= p and < limit
// (the chunk phase); otherwise iff it is < limit (the history).
template <int DP, bool CAUSAL, bool MASK>
__device__ __forceinline__ void attend_tile(uint32_t sQ, float (&o)[DP / 8][4], float (&mrow)[2],
                                            float (&lrow)[2], uint32_t sK, uint32_t sV, int j0,
                                            int limit, const int (&pos)[2], int lane, int wg) {
  constexpr int KT = DP / 16;
  constexpr int DT = DP / 8;
  const int c = lane & 3;
  float s[BK / 8][4];  // written whole by the first k step: no zeroing
  turn_wait(wg);
  wgmma_fence();
  wgmma_ss_n64<0>(&s[0][0], mat_desc(sQ, 128, 16 * DP), mat_desc(sK, 128, 16 * DP));
#pragma unroll
  for (int kk = 1; kk < KT; ++kk) {
    const uint64_t qd = mat_desc(sQ + kk * 256, 128, 16 * DP);
    const uint64_t kd = mat_desc(sK + kk * 256, 128, 16 * DP);
    wgmma_ss_n64<1>(&s[0][0], qd, kd);
  }
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait();
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(s[nt][e]);

  float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (MASK) {
        const int key = j0 + nt * 8 + 2 * c + (e & 1);
        const bool ok = CAUSAL ? (key <= pos[e >> 1] && key < limit) : (key < limit);
        s[nt][e] = ok ? s[nt][e] : NEG;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
  float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = ex2(mrow[i] - mx[i]);
    mrow[i] = mx[i];
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = !MASK || s[nt][e] > 0.5f * NEG ? ex2(s[nt][e] - mrow[e >> 1]) : 0.f;
      s[nt][e] = p;
      psum[e >> 1] += p;
    }
  }
  // Per-thread partial row sums; the quad's sum is taken once at the end.
  lrow[0] = lrow[0] * corr[0] + psum[0];
  lrow[1] = lrow[1] * corr[1] + psum[1];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    o[dt][0] *= corr[0];
    o[dt][1] *= corr[0];
    o[dt][2] *= corr[1];
    o[dt][3] *= corr[1];
  }
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack2(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack2(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(o[dt][e]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) pv_slices<DP, 0>(o, pa[kk], sV + kk * 256);
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_reg(o[dt][e]);
}


// One work item of the persistent grid: a (request, kv head, q tile) and
// its stream of tiles, the history's, then the chunk's causal prefix. Items
// are numbered with the longest q tiles of every (request, kv head) first.
struct Work {
  int b, h, qt;
  int len, hist;  // chunk length, history length
  int n_hist;     // history tiles
  int kv_hi;      // chunk keys any row of the q tile may see
  int n_tiles;
};

// HIST false (fresh prefill): no history, and a q tile wholly past the
// request's length is padding with no tiles.
template <bool HIST>
__device__ __forceinline__ Work work_item(const Args& a, int i, int G) {
  Work w;
  const int n_bh = a.B * a.Hkv;
  const int y = i / n_bh;
  const int x = i - y * n_bh;
  w.qt = a.n_qt - 1 - y;
  w.h = x % a.Hkv;
  w.b = x / a.Hkv;
  w.len = a.chunk_lens[w.b];
  w.hist = HIST ? a.start_pos[w.b] : 0;
  const int last = min(w.qt * BM + BM - 1, a.S * G - 1) / G;  // the q tile's last position
  w.n_hist = w.hist > 0 ? (w.hist + BK - 1) / BK : 0;
  w.kv_hi = min(last + 1, w.len);
  w.n_tiles = w.n_hist + (w.kv_hi > 0 ? (w.kv_hi + BK - 1) / BK : 0);
  if (!HIST && w.qt * BM / G >= w.len) w.n_tiles = 0;
  return w;
}

// The block's j-th item, -1 past the last. Passes over the grid alternate
// in direction: the longest q tiles come first, so a block that takes a long
// item in one pass takes a short one in the next, and no block is held to
// the items of one request when the grid and the (request, kv head) count
// nearly agree.
__device__ __forceinline__ int nth_item(int j, int n_items) {
  const int g = gridDim.x;
  const int k = j & 1 ? g - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int i = j * g + k;
  return i < n_items ? i : -1;
}

template <int DP, int KV>
__global__ void __launch_bounds__(THREADS, 1) chunked_prefill_kernel(const Args a) {
  using L = Layout<DP>;
  constexpr int DT = DP / 8;
  constexpr bool HIST = KV != KV_NONE;
  constexpr bool ONE_BYTE = one_byte_kv(KV);
  constexpr int EB = ONE_BYTE ? 1 : 2;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* empty = full + STAGES;

  const int G = a.Nq / a.Hkv;
  const int D = a.D;
  const int S = a.S;
  const int rows = S * G;  // packed rows of a request
  const long long ks = (long long)a.Hkv * D;  // position stride of k / v
  const int n_items = a.B * a.Hkv * a.n_qt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles never meet again

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: fills the ring, STAGES tiles ahead of the consumers,
    // running on into the block's next item while they finish this one.
    const int pt = threadIdx.x - CONSUMERS;
    const __nv_bfloat16* sbase =
        KV == KV_INT8 ? a.scales + (long long)a.layer * a.T * SCALE_LANES : nullptr;
    int* page_s = reinterpret_cast<int*>(smem + L::OFF_PAGE);
    int* rows_s = reinterpret_cast<int*>(smem + L::OFF_ROWS);
    uint8_t* raw = smem + L::OFF_RAW;
    uint32_t* scl = reinterpret_cast<uint32_t*>(smem + L::OFF_SCL);
    int g = 0;  // ring tiles filled, over every item of the block
    for (int j = 0, item; (item = nth_item(j, n_items)) >= 0; ++j) {
      const Work w = work_item<HIST>(a, item, G);
      const uint8_t* kpool =
          HIST ? a.pages + EB * ((long long)a.layer * 2 * a.T * ks + (long long)w.h * D) : nullptr;
      const uint8_t* vpool = HIST ? kpool + EB * a.T * ks : nullptr;
      const int* tb = HIST ? a.table + (long long)w.b * a.ppr : nullptr;
      const __nv_bfloat16* kb = a.k + (long long)w.b * S * ks + (long long)w.h * D;
      const __nv_bfloat16* vb = a.v + (long long)w.b * S * ks + (long long)w.h * D;
      // The pool rows of history tile t (-1 past hist): the thread of a
      // page's first key in the tile reads the page's entry, then each key's
      // thread forms its row. Neither this nor history() runs without a
      // history (n_hist is 0).
      auto fill_rows = [&](int t) {
        const int pos = t * BK + pt;
        const int page = pos / a.ps;
        const int off = pos - page * a.ps;
        producer_sync();  // every producer thread is done with the previous rows
        if (pt < BK && pos < w.hist && (pt == 0 || off == 0)) page_s[pt] = tb[min(page, a.ppr - 1)];
        producer_sync();
        if (pt < BK) rows_s[pt] = pos < w.hist ? page_s[max(pt - off, 0)] * a.ps + off : -1;
        producer_sync();
      };
      auto history = [&](uint8_t* dst, uint32_t* sc) {
        if constexpr (HIST) {
          if (a.ub_hist == 16) {
            load_history<DP, KV, 16>(pt, dst, sc, rows_s, kpool, vpool, sbase, w.h, D, a.Hkv);
          } else if (a.ub_hist == 8) {
            load_history<DP, KV, 8>(pt, dst, sc, rows_s, kpool, vpool, sbase, w.h, D, a.Hkv);
          } else if constexpr (KV == KV_BF16) {
            load_history<DP, KV, 4>(pt, dst, sc, rows_s, kpool, vpool, sbase, w.h, D, a.Hkv);
          } else if (a.ub_hist == 4) {
            load_history<DP, KV, 4>(pt, dst, sc, rows_s, kpool, vpool, sbase, w.h, D, a.Hkv);
          } else {  // a 1-byte pool at D = 2 mod 4
            load_history<DP, KV, 2>(pt, dst, sc, rows_s, kpool, vpool, sbase, w.h, D, a.Hkv);
          }
        }
      };
      if (ONE_BYTE && w.n_hist > 0) {  // raw tile 0 in flight before the loop
        fill_rows(0);
        history(raw, scl);
        commit_group();
      }
      for (int t = 0; t < w.n_tiles; ++t, ++g) {
        const int s = g % STAGES;
        uint8_t* stage = smem + s * L::STAGE;
        if (ONE_BYTE && t < w.n_hist) {
          // Raw tile t+1 goes out before tile t is dequantized into its stage.
          if (t + 1 < w.n_hist) {
            fill_rows(t + 1);
            history(raw + ((t + 1) & 1) * L::RAW, scl + ((t + 1) & 1) * (L::SCALES / 4));
            commit_group();
            wait_group<1>();
          } else {
            wait_group<0>();
          }
          producer_sync();  // every producer's copies of raw tile t have landed
          if (g >= STAGES) mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          dequant_tile<DP, KV>(pt, stage, raw + (t & 1) * L::RAW,
                               scl + (t & 1) * (L::SCALES / 4), w.h);
          fence_async_smem();
          mbar_arrive(&full[s]);
        } else {
          if (g >= STAGES) mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          if (t < w.n_hist) {
            fill_rows(t);
            history(stage, nullptr);
          } else {
            const int j0 = (t - w.n_hist) * BK;
            if (a.ub_chunk == 16) {
              load_chunk<DP, 16>(pt, stage, kb, vb, ks, j0, w.kv_hi, D);
            } else if (a.ub_chunk == 8) {
              load_chunk<DP, 8>(pt, stage, kb, vb, ks, j0, w.kv_hi, D);
            } else {
              load_chunk<DP, 4>(pt, stage, kb, vb, ks, j0, w.kv_hi, D);
            }
          }
          mbar_arrive_copies(&full[s]);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumer warpgroups.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int r = lane >> 2;
  const int c = lane & 3;
  const long long qs = (long long)a.Nq * D;  // position stride of q / out
  uint8_t* q_s = smem + L::OFF_Q + wg * (L::QTILE / WARPGROUPS);
  const uint32_t sQ = smem_u32(q_s);
  int g = 0;  // ring tiles taken, over every item of the block
  if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
  for (int j = 0, item; (item = nth_item(j, n_items)) >= 0; ++j) {
    const Work w = work_item<HIST>(a, item, G);
    if (!HIST && w.n_tiles == 0) continue;  // fresh prefill: a q tile of padding
    const int gf = w.qt * BM + wg * 64;  // the warpgroup's first row
    const int group_first = gf / G;                     // the warpgroup's first position
    const int group_last = min(gf + 63, rows - 1) / G;  // and its last
    // Fresh prefill computes no row past the length (padding, never read).
    const bool group_live = gf < rows && (HIST || group_first < w.len);

    // The warpgroup's q rows, scaled and rounded to bf16, into shared memory
    // (core-matrix layout); lanes D..DP-1 and rows past the request are
    // zeros; the stores wait until the warpgroup's products of the last
    // item are done with the tile.
    if constexpr (ONE_BYTE) {
      // One piece of 8 values at a time: with a 1-byte pool the producer's
      // dequantization sets the pace, and the unrolled loads below cost it
      // 3-7 % (PERF.md).
      if (j > 0) asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      for (int u = threadIdx.x & 127; u < 64 * (DP / 8); u += 128) {
        const int m = ((u >> 3) / (DP / 8)) * 8 + (u & 7);
        const int p = (u >> 3) % (DP / 8);
        const int f = gf + m;
        uint32_t q4[4] = {0u, 0u, 0u, 0u};
        if (f < rows) {
          const __nv_bfloat16* qrow =
              a.q + ((long long)w.b * S + f / G) * qs + (long long)(w.h * G + f % G) * D;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = 8 * p + 2 * i;
            if (d < D) {
              const float2 v =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qrow + d));
              q4[i] = pack2(v.x * a.qscale, v.y * a.qscale);
            }
          }
        }
        *reinterpret_cast<uint4*>(q_s + L::k_off(m, p)) = make_uint4(q4[0], q4[1], q4[2], q4[3]);
      }
    } else {
      // Each thread loads its QU pieces of 8 values (piece p of row m) first,
      // in loads of ub_q bytes, so that they take one trip to memory. Row m
      // is flat row gf + m: position p0 + x / G and head g0 + m - (x / G) *
      // G for x = g0 + m < 72, where x / G is (x * rG) >> 10 (exact below
      // 209 for G <= 8).
      constexpr int QU = DP / 16;
      const int p0 = gf / G, g0 = gf - p0 * G;
      const int rG = (1024 + G - 1) / G;
      uint32_t q4[QU][4];
#pragma unroll
      for (int k = 0; k < QU; ++k) {
        const int u = (threadIdx.x & 127) + 128 * k;
        const int m = ((u >> 3) / (DP / 8)) * 8 + (u & 7);
        const int p = (u >> 3) % (DP / 8);
        const int x = g0 + m;
        const int dx = (x * rG) >> 10;
        q4[k][0] = q4[k][1] = q4[k][2] = q4[k][3] = 0u;
        if (gf + m < rows && (HIST || p0 + dx < w.len) && 8 * p < D) {
          const __nv_bfloat16* qp = a.q + ((long long)w.b * S + p0 + dx) * qs +
                                    (long long)(w.h * G + x - dx * G) * D + 8 * p;
          if (a.ub_q == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(qp);
            q4[k][0] = v.x, q4[k][1] = v.y, q4[k][2] = v.z, q4[k][3] = v.w;
          } else if (a.ub_q == 8) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (8 * p + 4 * i < D) {
                const uint2 v = *reinterpret_cast<const uint2*>(qp + 4 * i);
                q4[k][2 * i] = v.x, q4[k][2 * i + 1] = v.y;
              }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (8 * p + 2 * i < D) q4[k][i] = *reinterpret_cast<const uint32_t*>(qp + 2 * i);
          }
        }
      }
      if (j > 0) asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
      for (int k = 0; k < QU; ++k) {
        const int u = (threadIdx.x & 127) + 128 * k;
        uint32_t w4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // zeros stay zeros
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q4[k][i]));
          w4[i] = pack2(v.x * a.qscale, v.y * a.qscale);
        }
        *reinterpret_cast<uint4*>(q_s + L::k_off(((u >> 3) / (DP / 8)) * 8 + (u & 7),
                                                 (u >> 3) % (DP / 8))) =
            make_uint4(w4[0], w4[1], w4[2], w4[3]);
      }
    }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");

    // This thread's two packed rows: flat f = position * G + g.
    const int wf = w.qt * BM + warp * 16;  // the warp's first row
    int pos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) pos[i] = (wf + r + 8 * i) / G;
    float o[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float mrow[2] = {NEG, NEG};
    float lrow[2] = {0.f, 0.f};

    for (int t = 0; t < w.n_tiles; ++t, ++g) {
      const int s = g % STAGES;
      mbar_wait(&full[s], (g / STAGES) & 1);
      fence_async_smem();
      const uint32_t sK = smem_u32(smem + s * L::STAGE);
      const uint32_t sV = sK + L::TILE;
      if (t < w.n_hist) {
        const int j0 = t * BK;
        if (!group_live) {
          turn_wait(wg);
          turn_pass(wg);
        } else if (j0 + BK <= w.hist) {  // every key of the tile is visible
          attend_tile<DP, false, false>(sQ, o, mrow, lrow, sK, sV, j0, w.hist, pos, lane, wg);
        } else {
          attend_tile<DP, false, true>(sQ, o, mrow, lrow, sK, sV, j0, w.hist, pos, lane, wg);
        }
      } else {
        const int j0 = (t - w.n_hist) * BK;
        if (!group_live || j0 > group_last) {  // the tile is above the diagonal
          turn_wait(wg);
          turn_pass(wg);
        } else if (j0 + BK - 1 <= group_first && j0 + BK <= w.len) {
          attend_tile<DP, true, false>(sQ, o, mrow, lrow, sK, sV, j0, w.len, pos, lane, wg);
        } else {
          attend_tile<DP, true, true>(sQ, o, mrow, lrow, sK, sV, j0, w.len, pos, lane, wg);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    float lt[2], inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lt[i] = lrow[i];
      lt[i] += __shfl_xor_sync(0xffffffffu, lt[i], 1);
      lt[i] += __shfl_xor_sync(0xffffffffu, lt[i], 2);
      inv[i] = 1.f / fmaxf(lt[i], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = wf + r + 8 * i;
      if (f >= rows || (!HIST && pos[i] >= w.len)) continue;  // fresh: padding is not stored
      // element offset of the row's head in q / out
      const long long qoff = ((long long)w.b * S + pos[i]) * qs + (long long)(w.h * G + f % G) * D;
      __nv_bfloat16* orow = a.out + qoff;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int d = dt * 8 + 2 * c;
        if (d < D)  // a padding column is never stored
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(o[dt][2 * i] * inv[i], o[dt][2 * i + 1] * inv[i]);
      }
      if (a.m_out && c == 0) {
        const long long mi = qoff / D;  // (b * S + pos) * Nq + head
        a.m_out[mi] = mrow[i];
        a.l_out[mi] = lt[i];
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

template <int DP, int KV>
int run(const Args& a, dim3 grid, cudaStream_t st) {
  constexpr int bytes = Layout<DP>::bytes(one_byte_kv(KV));
  static bool ready = false;  // the attribute is set once per instance
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunked_prefill_kernel<DP, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  chunked_prefill_kernel<DP, KV><<<grid, THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// The largest copy (bytes) up to 16 that divides a row of D values of EB
// bytes and that the pointer's alignment allows, at least MIN.
int copy_bytes(int D, int EB, const void* p, int min_bytes) {
  int ub = 16;
  while (ub > min_bytes && ((EB * D) % ub != 0 || !aligned(p, ub))) ub /= 2;
  return ((EB * D) % ub == 0 && aligned(p, ub)) ? ub : 0;
}

template <int KV>
int launch(Args a, void* stream) {
  if (a.Hkv <= 0 || a.Nq % a.Hkv != 0 || a.Nq / a.Hkv > MAX_G) return (int)cudaErrorInvalidValue;
  if (a.D <= 0 || a.D > MAX_D || a.D % 2 != 0) return (int)cudaErrorInvalidValue;
  if ((a.m_out == nullptr) != (a.l_out == nullptr)) return (int)cudaErrorInvalidValue;
  if constexpr (KV != KV_NONE) {  // the pool
    if (a.ps <= 0 || a.ppr <= 0) return (int)cudaErrorInvalidValue;
    if (KV == KV_INT8 && (a.scales == nullptr || a.Hkv > SCALE_LANES / 2 || !aligned(a.scales, 4)))
      return (int)cudaErrorInvalidValue;
    a.ub_hist = copy_bytes(a.D, one_byte_kv(KV) ? 1 : 2, a.pages, KV == KV_BF16 ? 4 : 2);
    if (a.ub_hist == 0) return (int)cudaErrorMisalignedAddress;
  }
  a.ub_chunk = copy_bytes(a.D, 2, reinterpret_cast<const void*>(
                                      reinterpret_cast<uintptr_t>(a.k) |
                                      reinterpret_cast<uintptr_t>(a.v)), 4);
  a.ub_q = copy_bytes(a.D, 2, a.q, 4);
  if (a.ub_chunk == 0 || a.ub_q == 0) return (int)cudaErrorMisalignedAddress;
  const long long n_qt = ((long long)a.S * (a.Nq / a.Hkv) + BM - 1) / BM;
  const long long n_items = n_qt * a.B * a.Hkv;
  if (n_items > INT_MAX) return (int)cudaErrorInvalidValue;
  a.n_qt = (int)n_qt;
  // With a history, a persistent grid: one block per SM (the shared memory
  // or the registers allow no more). Fresh prefill: one block per item, in
  // the hardware's order (the longest q tiles first), which balances ragged
  // batches, whose padding items are empty, better than the static passes.
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(KV == KV_NONE ? n_items : std::min<long long>(n_items, sms)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((a.D + 15) / 16 * 16) {  // DP: D padded to the mma k-step
    case 16: return run<16, KV>(a, grid, st);
    case 32: return run<32, KV>(a, grid, st);
    case 48: return run<48, KV>(a, grid, st);
    case 64: return run<64, KV>(a, grid, st);
    case 80: return run<80, KV>(a, grid, st);
    case 96: return run<96, KV>(a, grid, st);
    case 112: return run<112, KV>(a, grid, st);
    default: return run<128, KV>(a, grid, st);
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory (bytes) of the instance that takes head dim D for a
// pool of kv type 0 (bf16), 1 (int8) or 2 (fp8), or 3 for no pool (K2 / K8).
extern "C" int flash_prefill_chunked_smem(int D, int kv) {
  const bool one_byte = one_byte_kv(kv);
  switch ((D + 15) / 16 * 16) {
    case 16: return Layout<16>::bytes(one_byte);
    case 32: return Layout<32>::bytes(one_byte);
    case 48: return Layout<48>::bytes(one_byte);
    case 64: return Layout<64>::bytes(one_byte);
    case 80: return Layout<80>::bytes(one_byte);
    case 96: return Layout<96>::bytes(one_byte);
    case 112: return Layout<112>::bytes(one_byte);
    default: return Layout<128>::bytes(one_byte);
  }
}

// K5 (bf16 pool) and K5q (int8 / fp8 pool): a chunk over the pool's history,
// any even head dim up to 128. scales: the int8 pool's merged [L, T, 128]
// bf16 slab, null otherwise. m and l may be null (no state out).
#define CHUNKED_ENTRY(NAME, KV)                                                               \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* chunk_lens,   \
                      const void* start_pos, const void* pages, const void* scales,          \
                      const void* table, void* out, void* m, void* l, int B, int S, int Nq,   \
                      int Hkv, int D, float qscale, long long T, int layer, int ps, int ppr,  \
                      void* stream) {                                                         \
    Args a;                                                                                   \
    a.q = static_cast<const __nv_bfloat16*>(q);                                               \
    a.k = static_cast<const __nv_bfloat16*>(k);                                               \
    a.v = static_cast<const __nv_bfloat16*>(v);                                               \
    a.chunk_lens = static_cast<const int*>(chunk_lens);                                       \
    a.start_pos = static_cast<const int*>(start_pos);                                         \
    a.pages = static_cast<const uint8_t*>(pages);                                             \
    a.scales = static_cast<const __nv_bfloat16*>(scales);                                     \
    a.table = static_cast<const int*>(table);                                                 \
    a.out = static_cast<__nv_bfloat16*>(out);                                                 \
    a.m_out = static_cast<float*>(m);                                                         \
    a.l_out = static_cast<float*>(l);                                                         \
    a.B = B;                                                                                  \
    a.S = S;                                                                                  \
    a.Nq = Nq;                                                                                \
    a.Hkv = Hkv;                                                                              \
    a.D = D;                                                                                  \
    a.ub_hist = a.ub_chunk = 0;                                                               \
    a.qscale = qscale;                                                                        \
    a.T = T;                                                                                  \
    a.layer = layer;                                                                          \
    a.ps = ps;                                                                                \
    a.ppr = ppr;                                                                              \
    return launch<KV>(a, stream);                                                          \
  }

CHUNKED_ENTRY(flash_prefill_chunked_bf16, KV_BF16)
CHUNKED_ENTRY(flash_prefill_chunked_int8, KV_INT8)
CHUNKED_ENTRY(flash_prefill_chunked_fp8, KV_FP8)

// K2 and K8: fresh prefill, the instance with no history (chunk_lens =
// seq_lens, no pool, no state out). K2 takes head dims 64 and 128, K8 any
// even one up to 128 (the callers send it the others); both launch the same
// instances. Rows at or past seq_lens[b] are left as they were.
extern "C" int flash_prefill_vmem_bf16(const void* q, const void* k, const void* v,
                                       const void* seq_lens, void* out, int B, int S, int Nq,
                                       int Hkv, int D, float qscale, void* stream) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.chunk_lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.S = S;
  a.Nq = Nq;
  a.Hkv = Hkv;
  a.D = D;
  a.qscale = qscale;
  return launch<KV_NONE>(a, stream);
}

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* seq_lens, void* out, int B, int S, int Nq,
                                  int Hkv, int D, float qscale, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  return flash_prefill_vmem_bf16(q, k, v, seq_lens, out, B, S, Nq, Hkv, D, qscale, stream);
}
