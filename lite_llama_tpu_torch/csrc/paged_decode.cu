// Paged flash-decode attention for Hopper (sm_90a): K1 (bf16 pool) and K1q
// (int8 and fp8 pools), one kernel template.
//
// Replaces the TPU kernel lite_llama_tpu/ops/attention_decode.py
// paged_flash_decode / _decode_kernel (its quantized=True branch and the fp8
// cast of its page tiles included): decode-step attention, one query token
// per request, reading K/V straight out of the paged pool [L, 2, T, Hkv*D]
// (K/V planes, flat token rows, head-major channels) through the page table,
// and returning the online-softmax state (m, l) in the exp2 domain beside the
// normalised output, so that the caller can fold in the newest token
// (ops/ref.py fold_new_token). q is scaled by sm_scale*log2(e) and rounded to
// bf16; P is rounded to bf16 before PV and l sums the unrounded P. An int8
// pool's per-(token, head) bf16 scales (the merged [L, T, 128] slab: K in
// lane hoff + h, V in lane 64 + hoff + h, hoff the first global kv head of
// a tensor-parallel shard, 0 on one device) apply in the score domain: s = (q . k_int) *
// k_scale, l sums the unscaled P, and PV takes bf16(P * v_scale) against the
// integer V values. fp8 e4m3 values convert to bf16 exactly. kv_len 0 gives
// m = -1e30, l = 0, out = 0. Any even head dim from 16 to 128, and 256; 1
// to 16 query heads per kv head.
//
// What bounds it: device-memory bytes. Every K and V row of every live token
// is read once, sum(kv_len) * 2 * Hkv * D bytes per pool byte, against a few
// operations per byte. At the decode batch (12 requests of 88 tokens) the
// whole read is 4.3 MB, 1.3 us at 3.35 TB/s, so the time is the chain of
// dependent memory round trips (kv_lens, page ids, K/V rows, the partials);
// at serving's width (8 slots of 1,820 tokens among 64) it is 59.6 MB and the
// bandwidth, plus that chain once.
//
// Design. The first version (one block per (kv head, request), eight warps
// of CUDA-core dot products) left most SMs idle at long contexts, kept 32
// rows per block in flight, reduced every score with five shuffle levels and
// merged eight warps' states through 32 KB of shared memory. Here:
// 1. Flash decoding: the KV walk of a (request, kv head) is split across
//    blocks, and the device decides the split from kv_lens. The grid is
//    (Hkv, slots): slots is one wave of resident blocks over the kv heads
//    (the occupancy query, at most B * s_max), and block (h, y) takes the
//    items y, y + slots, ... of the list [request 0's splits, request 1's,
//    ...]. Warp 0 of every block reads all kv_lens (up to PER_LANE loads
//    per lane, issued at once, for each group of 256 requests; a larger
//    batch scans its further groups in turn, out of line) and scans them:
//    a request of n pages among the launch's N takes its share of the
//    slots, floor(slots * n / N), at least 1, at most s_max and at most one
//    per min_span pages (the host's
//    plan from static shapes, ops/attention_decode.py plan_decode_splits),
//    as spans of cdiv(n, live) whole pages. So the live work of a launch
//    fills one wave whatever the batch's lengths: serving's 56 empty slots
//    take no block (every block writes a few empty states after its items),
//    a lone long request takes the whole card, and a batch of short ones
//    takes one split each. (A request's split, and so the last bits of its
//    result, depend on the other lengths of its batch; a split count from
//    a request's own length alone leaves the card idle where a few long
//    requests share a launch with short or empty ones.) One split writes
//    out, m and l itself. Several
//    write their fp32 (m, l, unnormalised acc) partials into the workspace
//    of the stream; the block that arrives last for its (request, kv head),
//    found by an atomic counter after a fence, combines them in split order
//    (m = max m_s, l = sum l_s 2^(m_s - m), out = sum acc_s 2^(m_s - m) / l)
//    from shared memory (the partials copied in one round trip) and sets
//    the counter back to 0. No host read of a device value and no order that
//    depends on which block arrives first: launches are bit-identical run to
//    run and capturable in a CUDA graph. (One launch, not a second combine
//    kernel: the combine is a few KB from L2 read by a block that is already
//    resident; a launch costs more.)
// 2. Shared memory by asynchronous copies. The block forms the pool row of
//    each token of a chunk (one page-table read per token, a division by the
//    page size done as a multiply by its reciprocal) one chunk ahead of its
//    copies, and keeps a ring of STAGES = 2 chunks of CH = 64 tokens in
//    flight with cp.async (16-byte copies, or 8 / 4 / 2 where D's alignment
//    forbids 16; zeros past the span and in the pad lanes D..DP-1), each
//    chunk's copies completing its stage's mbarrier
//    (cp.async.mbarrier.arrive). At the decode batch a block's whole span
//    (88 tokens) is in flight before the first product. Rows are padded by
//    16 bytes so that ldmatrix's eight rows fall on distinct banks. Any page
//    size.
// 3. Tensor cores on packed query heads: mma.sync m16n8k16 in bf16 with the
//    16 tokens of a warp's subtile on M and the G query heads of the kv head
//    on N, in NT n8 tiles (NT 1 for G <= 8, 2 for G <= 16: each K and V
//    fragment, loaded once, meets both): S^T = K . q^T (K by ldmatrix, q as
//    B fragments held in registers, loaded once), then out^T = V^T . P^T
//    (V^T by ldmatrix.trans, P^T from S^T's accumulators by movmatrix.trans:
//    the C layout of S^T and the B layout of P^T are each other's
//    transposes). A thread holds two heads of each n8 tile's scores: the row
//    max over 16 tokens is three shuffle levels and the row sums are reduced
//    once at the end. A 1-byte
//    pool's raw rows go through the same ldmatrix (as pairs of bytes) and
//    become bf16 in registers, exactly: for K the contraction order of the
//    dims is permuted (and q's fragments with it), for V the output dims
//    (an 8 x 8 b16 matrix transposed holds two dims per thread). int8 scales
//    arrive with the chunk (the aligned bf16 pair of the slab holding lane
//    h, and lane 64 + h), a word per token each.
// 4. Four warps take a chunk's four 16-token subtiles, each keeping its own
//    online softmax (exp2 of the SFU, fp32 in registers); at the end only
//    the warps that saw a token merge their states through shared memory
//    (the ring's space), each thread taking one dim of every head (two at
//    DP 256).
// Not carried over from the TPU: the wide MXU form with a block-identity
// mask and the cross-program DMA lookahead (a GPU grid has no order); the
// split-KV two-stage decoding the TPU kernel's docstring names as its
// reference is what item 1 brings back.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"  // smem_u32, mbarriers

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int SUB = 16;            // tokens per warp subtile (the mma's M)
constexpr int CH = SUB * WARPS;    // tokens per ring stage
constexpr int STAGES = 2;         // ring stages: the next chunk loads while one is computed
constexpr int MAX_SPLITS = 16;     // ops/attention_decode.py DECODE_MAX_SPLITS
constexpr int MAX_G = 16;          // query heads per kv head: two n8 tiles of the mma's N
constexpr int PER_LANE = 8;        // requests per lane of the item scan
constexpr int MAX_B = 32 * PER_LANE;  // requests per group of the scan
constexpr int SCALE_LANES = 128;   // the int8 pool's merged scale slab
constexpr float NEG = -1e30f;

enum KvType { KV_BF16 = 0, KV_INT8 = 1, KV_FP8 = 2 };

// Shared memory of one instance: the ring, then one full barrier per stage,
// then the pool rows of the tokens of STAGES + 1 chunks. A stage is CH rows
// of K and CH rows of V (RB value bytes each, stride RS) and, for int8, two
// scale words per token. DP, the padded head dim, is a multiple of 16 (bf16) or 32
// (1-byte pools), so RB is a multiple of 32 and RS / 16 is odd. GT = 8 NT
// heads: the instance's n8 tiles.
template <int DP, int KV, int NT>
struct Layout {
  static constexpr int GT = 8 * NT;
  static constexpr int EB = KV == KV_BF16 ? 2 : 1;  // bytes per pool value
  static constexpr int RB = DP * EB;
  static constexpr int RS = RB + 16;
  static constexpr int TILE = CH * RS;
  static constexpr int STAGE = 2 * TILE + (KV == KV_INT8 ? CH * 8 : 0);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int MERGE = (WARPS * GT * DP + 2 * WARPS * GT) * 4;
  static_assert(MERGE <= RING, "the warps' merge reuses the ring");
  static_assert((2 * MAX_SPLITS + 2 + DP) * GT * 4 <= RING,
                "so does the splits' combine: every (m, l) and one acc partial at least");
  static constexpr int BYTES = RING + STAGES * 8 + (STAGES + 1) * CH * 4;
};

struct Args {
  const __nv_bfloat16* q;       // [B, Nq, D]
  const uint8_t* pages;         // [L, 2, T, Hkv*D] of bf16, int8 or fp8
  const __nv_bfloat16* scales;  // [L, T, 128] (int8 pools only)
  const int* table;             // [B, ppr]
  const int* kv_lens;           // [B]
  __nv_bfloat16* out;           // [B, Nq, D]
  float* m_out;                 // [B, Nq]
  float* l_out;                 // [B, Nq]
  float* ws;                    // split partials [B * Hkv * s_max][roundup(G*D, 4) + 2 GT]
                                // (s_max > 1)
  int* counters;                // [B * Hkv], 0 between launches (s_max > 1)
  int B, Nq, Hkv, D, G;
  int hoff;                     // scale lanes of kv head h: hoff + h and 64 + hoff + h
  long long T;
  int layer, ps, ppr;
  unsigned long long ps_recip;  // ceil(2^32 / ps): j / ps == (j * ps_recip) >> 32 when
                                // j * ps < 2^32
  int s_max, min_span, ub;
  float qscale;
};


__device__ __forceinline__ int div_ps(const Args& a, int j) {
  return (int)(((unsigned long long)(unsigned)j * a.ps_recip) >> 32);
}

// UB bytes from global to shared memory, zeros when !valid: 16 bytes by
// cp.async.cg (each byte is read once, L1 is no use), 8 and 4 by .ca, 2
// (a 1-byte pool at D = 2 mod 4) through a register.
template <int UB>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  if constexpr (UB == 2) {
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  } else if constexpr (UB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(UB), "r"(valid ? UB : 0)
                 : "memory");
  }
}


__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// The 8 x 8 b16 matrix the warp holds in fragment layout, transposed.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += a . b, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU's approximation (relative error ~2^-22, subnormal results
// flushed to zero): P is rounded to bf16 (2^-8) right after.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats -> one bf16x2 register; the first goes to the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bytes I (low half) and J (high half) of w, 1-byte pool values, as an exact
// bf16x2: int8 through a float's mantissa (x + 2^23 + 128 assembled by a
// byte permute, minus the offset; no conversion instruction), fp8 e4m3 via
// fp16.
template <int KV, int I, int J>
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t w) {
  if constexpr (KV == KV_INT8) {
    const uint32_t wx = w ^ 0x80808080u;
    const float lo = __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + I)) - 8388736.f;
    const float hi = __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + J)) - 8388736.f;
    return pack2(lo, hi);
  } else {
    const uint32_t pair = __byte_perm(w, 0u, I | (J << 4));
    const __half2 hv(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair),
                                                __NV_E4M3));
    const float2 f = __half22float2(hv);
    return pack2(f.x, f.y);
  }
}

// The output dim of accumulator element e (0..3) of m-tile mt held by the
// thread in row group r: bf16 V^T fragments keep the natural order, a
// 1-byte pool's put dims 2r and 2r + 1 in rows r and r + 8.
template <int KV>
__device__ __forceinline__ int acc_dim(int mt, int e, int r) {
  return KV == KV_BF16 ? 16 * mt + r + 8 * (e >> 1) : 16 * mt + 2 * r + (e >> 1);
}

// A work item: split z of request b's live splits.
struct Item {
  int b, z, live, span, len;
};

// floor(n / d) for n >= 0, d >= 1 without a division instruction sequence:
// the estimate by the SFU's reciprocal (relative error ~2^-23) is within 1 of
// it for n < 2^22, then one correction. (The scan below divides several times per request in a
// dependent chain; an integer division is some 20 dependent instructions.)
__device__ __forceinline__ int udiv(int n, int d) {
  if (n >= (1 << 22)) return n / d;
  float rcp;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(rcp) : "f"((float)d));
  int q = (int)((float)n * rcp);
  const int r = n - q * d;
  if (r < 0) --q;
  else if (r >= d) ++q;
  return q;
}

__device__ __forceinline__ int cdiv(int n, int d) { return udiv(n + d - 1, d); }

// The live splits of a request of n > 0 pages among total pages of the
// launch, the grid holding `slots` items per wave: its share of the slots,
// at least 1, at most s_max and at most one per min_span pages; then spans
// of cdiv(n, live) pages, recounted so that none is empty.
__device__ __forceinline__ int live_splits(const Args& a, int n, int total, int slots) {
  const long long sn = (long long)slots * n;
  const int share = max(1, sn < (1 << 22) ? udiv((int)sn, total) : (int)(sn / total));
  const int live0 = min(share, min(a.s_max, cdiv(n, a.min_span)));
  return cdiv(n, cdiv(n, live0));
}

// The launch's items, [request 0's splits, request 1's, ...], and its empty
// requests, as warp 0 holds them for one group of MAX_B requests (a batch
// of more takes its groups in turn): lane t owns the group's requests
// [t * per, (t + 1) * per), each as len | live << 24 (-1 past the batch),
// the items [first, first + n) and the empty requests [first_e, first_e +
// n_e); end and end_e count the items and empty requests up to the group's
// last (the same in every lane).
struct ItemScan {
  int req[PER_LANE];
  int base, per, first, n, first_e, n_e, end, end_e;
};

__device__ __forceinline__ int scan_inclusive(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += t;
  }
  return x;
}

// Group grp's lengths, clamped to [0, the table's reach]; returns the
// group's pages (in every lane).
__device__ __forceinline__ int load_group(const Args& a, int lane, int grp, ItemScan& sc) {
  sc.base = grp * MAX_B;
  const int nb = min(MAX_B, a.B - sc.base);
  sc.per = (nb + 31) / 32;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {  // every load issued before any use
    const int b = lane * sc.per + k;
    sc.req[k] = (k < sc.per && b < nb) ? a.kv_lens[sc.base + b] : -1;
  }
  const int reach = a.ppr * a.ps;
  int pages = 0;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    if (k < sc.per && lane * sc.per + k < nb) sc.req[k] = min(max(sc.req[k], 0), reach);
    if (sc.req[k] > 0) pages += div_ps(a, sc.req[k] + a.ps - 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pages += __shfl_xor_sync(0xffffffffu, pages, o);
  return pages;
}

// The loaded group's live splits, `items0` items and `empties0` empty
// requests coming before it, among `total` pages of the launch.
__device__ __forceinline__ void split_group(const Args& a, int lane, int total, int slots,
                                            int items0, int empties0, ItemScan& sc) {
  sc.n = sc.n_e = 0;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    if (sc.req[k] > 0) {
      const int live = live_splits(a, div_ps(a, sc.req[k] + a.ps - 1), total, slots);
      sc.n += live;
      sc.req[k] |= live << 24;
    } else if (sc.req[k] == 0) {
      ++sc.n_e;
    }
  }
  sc.first = items0 + scan_inclusive(sc.n, lane) - sc.n;
  sc.first_e = empties0 + scan_inclusive(sc.n_e, lane) - sc.n_e;
  sc.end = __shfl_sync(0xffffffffu, sc.first + sc.n, 31);
  sc.end_e = __shfl_sync(0xffffffffu, sc.first_e + sc.n_e, 31);
}

// Batches of more than MAX_B requests only, out of line so that the code
// of a launch's usual path stays small (it runs cold, from L2, in a decode
// step): the pages of groups 1, 2, ...; and group grp scanned, `items0`
// items and `empties0` empty requests before it.
__device__ __noinline__ int pages_past_group_0(const Args& a, int lane) {
  int pages = 0;
  for (int grp = 1; grp * MAX_B < a.B; ++grp) {
    ItemScan t;
    pages += load_group(a, lane, grp, t);
  }
  return pages;
}

__device__ __noinline__ void scan_group(const Args& a, int lane, int grp, int total, int slots,
                                        int items0, int empties0, ItemScan* sc) {
  ItemScan t;
  load_group(a, lane, grp, t);
  split_group(a, lane, total, slots, items0, empties0, t);
  *sc = t;
}

// Moves the scan to the group that holds item y (by_items) or empty
// request y, from group 0 (from_start) or from the scan's group onward.
__device__ __forceinline__ void seek_group(const Args& a, int lane, int total, int slots, int y,
                                           bool by_items, bool from_start, ItemScan& sc) {
  if (a.B <= MAX_B) return;  // one group
  if (from_start && sc.base != 0) {
    ItemScan t;
    scan_group(a, lane, 0, total, slots, 0, 0, &t);
    sc = t;
  }
  while ((by_items ? y >= sc.end : y >= sc.end_e) && sc.base + MAX_B < a.B) {
    ItemScan t;
    scan_group(a, lane, sc.base / MAX_B + 1, total, slots, sc.end, sc.end_e, &t);
    sc = t;
  }
}

// Item y if this lane owns it.
__device__ __forceinline__ bool lookup_item(const Args& a, const ItemScan& sc, int y, int lane,
                                            Item* it) {
  if (y < sc.first || y >= sc.first + sc.n) return false;
  int first = sc.first;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    if (sc.req[k] <= 0) continue;
    const int live = sc.req[k] >> 24;
    if (y < first + live) {
      const int len = sc.req[k] & 0xFFFFFF;
      *it = Item{sc.base + lane * sc.per + k, y - first, live,
                 cdiv(div_ps(a, len + a.ps - 1), live), len};
      return true;
    }
    first += live;
  }
  return false;
}

// The request of empty request e if this lane owns it, else -1.
__device__ __forceinline__ int lookup_empty(const ItemScan& sc, int e, int lane) {
  if (e < sc.first_e || e >= sc.first_e + sc.n_e) return -1;
  int first = sc.first_e;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    if (sc.req[k] != 0) continue;
    if (e == first) return sc.base + lane * sc.per + k;
    ++first;
  }
  return -1;
}

// Stage s's copies of the K/V rows rows[0..CH) (-1: zeros) and, for int8,
// their scale words; then this thread's arrival on the stage's barrier.
template <int DP, int KV, int UB>
__device__ __forceinline__ void fill_stage(const Args& a, uint8_t* st, const int* rows,
                                           uint64_t* full, int h, int tid) {
  using L = Layout<DP, KV, 1>;  // the ring's geometry is the same for any NT
  constexpr int EB = L::EB;
  constexpr int NP = L::RB / UB;  // copies per row
  const long long rb = (long long)EB * a.Hkv * a.D;  // bytes per pool row
  const uint8_t* kpool = a.pages + EB * ((long long)a.layer * 2 * a.T * a.Hkv * a.D +
                                         (long long)h * a.D);
  const uint8_t* vpool = kpool + a.T * rb;
  const int db = EB * a.D;  // value bytes of a row
#pragma unroll 4
  for (int u = tid; u < CH * NP; u += THREADS) {
    const int n = u / NP;
    const int p = u - n * NP;
    const int row = rows[n];
    const bool ok = row >= 0 && p * UB < db;
    const long long src = ok ? row * rb + p * UB : 0;
    copy_async<UB>(st + n * L::RS + p * UB, kpool + src, ok);
    copy_async<UB>(st + L::TILE + n * L::RS + p * UB, vpool + src, ok);
  }
  if constexpr (KV == KV_INT8) {
    // The aligned bf16 pairs of the slab holding lanes hoff + h and 64 + hoff + h.
    const __nv_bfloat16* sb =
        a.scales + (long long)a.layer * a.T * SCALE_LANES + ((a.hoff + h) & ~1);
    uint8_t* scl = st + 2 * L::TILE;
    for (int n = tid; n < CH; n += THREADS) {
      const int row = rows[n];
      const __nv_bfloat16* s = sb + (long long)max(row, 0) * SCALE_LANES;
      copy_async<4>(scl + 8 * n, s, row >= 0);
      copy_async<4>(scl + 8 * n + 4, s + SCALE_LANES / 2, row >= 0);
    }
  }
  if constexpr (UB == 2) {  // register copies: plain stores, then a release
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    mbar_arrive(full);
  } else {
    mbar_arrive_copies(full);
  }
}

template <int DP, int KV>
__device__ __forceinline__ void fill(const Args& a, uint8_t* st, const int* rows, uint64_t* full,
                                     int h, int tid) {
  switch (a.ub) {
    case 16: fill_stage<DP, KV, 16>(a, st, rows, full, h, tid); break;
    case 8: fill_stage<DP, KV, 8>(a, st, rows, full, h, tid); break;
    case 4: fill_stage<DP, KV, 4>(a, st, rows, full, h, tid); break;
    default:
      if constexpr (KV != KV_BF16) fill_stage<DP, KV, 2>(a, st, rows, full, h, tid);
      break;
  }
}

// One warp's 16-token subtile (rows jl.. of stage st, the first of them
// token j0 of the span) against the G query heads, NT n8 tiles of them:
// scores, online-softmax update, out^T += V^T P^T. lh: the kv head's scale
// lane (int8 pools).
template <int DP, int KV, int NT>
__device__ __forceinline__ void attend(const uint8_t* st, int jl, int j0, int n_tok, int lh,
                                       const uint32_t (&qf)[NT][DP / 16][2],
                                       float (&acc)[NT][DP / 16][4], float (&mrun)[NT][2],
                                       float (&lrun)[NT][2], int lane) {
  using L = Layout<DP, KV, NT>;
  constexpr int KT = DP / 16;
  const int r = lane >> 2;
  // S^T = K q^T: A from ldmatrix, each x4 32 bytes of 16 rows.
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  const uint32_t kaddr =
      smem_u32(st) + (jl + (lane & 7) + ((lane >> 3) & 1) * 8) * L::RS + (lane >> 4) * 16;
#pragma unroll
  for (int x = 0; x < L::RB / 32; ++x) {
    uint32_t m4[4];
    ldsm_x4(m4, kaddr + 32 * x);
    if constexpr (KV == KV_BF16) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(s[nt], m4, qf[nt][x][0], qf[nt][x][1]);
    } else {
      // Each register holds four consecutive dims of one token: the first
      // pair is the k step's low half, the second its high half.
      const uint32_t a0[4] = {bytes_bf16x2<KV, 0, 1>(m4[0]), bytes_bf16x2<KV, 0, 1>(m4[1]),
                              bytes_bf16x2<KV, 2, 3>(m4[0]), bytes_bf16x2<KV, 2, 3>(m4[1])};
      const uint32_t a1[4] = {bytes_bf16x2<KV, 0, 1>(m4[2]), bytes_bf16x2<KV, 0, 1>(m4[3]),
                              bytes_bf16x2<KV, 2, 3>(m4[2]), bytes_bf16x2<KV, 2, 3>(m4[3])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(s[nt], a0, qf[nt][2 * x][0], qf[nt][2 * x][1]);
        mma_bf16(s[nt], a1, qf[nt][2 * x + 1][0], qf[nt][2 * x + 1][1]);
      }
    }
  }
  // Rows r and r + 8 of S^T (tokens), columns 2c and 2c + 1 of each n8 tile
  // (heads 8 nt + 2c and 8 nt + 2c + 1).
  const bool v0 = j0 + r < n_tok;
  const bool v1 = j0 + r + 8 < n_tok;
  float vs0 = 1.f, vs1 = 1.f;
  if constexpr (KV == KV_INT8) {
    const uint32_t* scl = reinterpret_cast<const uint32_t*>(st + 2 * L::TILE);
    const int sh = (lh & 1) * 16;  // the pair's half that holds lane lh
    const float ks0 = __uint_as_float((scl[2 * (jl + r)] >> sh) << 16);
    const float ks1 = __uint_as_float((scl[2 * (jl + r + 8)] >> sh) << 16);
    vs0 = __uint_as_float((scl[2 * (jl + r) + 1] >> sh) << 16);
    vs1 = __uint_as_float((scl[2 * (jl + r + 8) + 1] >> sh) << 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] *= ks0;
      s[nt][1] *= ks0;
      s[nt][2] *= ks1;
      s[nt][3] *= ks1;
    }
  }
  uint32_t b0[NT], b1[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float mx[2] = {fmaxf(v0 ? s[nt][0] : NEG, v1 ? s[nt][2] : NEG),
                   fmaxf(v0 ? s[nt][1] : NEG, v1 ? s[nt][3] : NEG)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(mrun[nt][i], mx[i]);
      corr[i] = ex2(mrun[nt][i] - mn);
      mrun[nt][i] = mn;
    }
    const float p0 = v0 ? ex2(s[nt][0] - mrun[nt][0]) : 0.f;
    const float p1 = v0 ? ex2(s[nt][1] - mrun[nt][1]) : 0.f;
    const float p2 = v1 ? ex2(s[nt][2] - mrun[nt][0]) : 0.f;
    const float p3 = v1 ? ex2(s[nt][3] - mrun[nt][1]) : 0.f;
    // l sums the unrounded P (per thread; the row group's sum is taken once
    // at the end); an int8 pool folds the V scale into P before its rounding.
    lrun[nt][0] = lrun[nt][0] * corr[0] + p0 + p2;
    lrun[nt][1] = lrun[nt][1] * corr[1] + p1 + p3;
#pragma unroll
    for (int mt = 0; mt < KT; ++mt) {
      acc[nt][mt][0] *= corr[0];
      acc[nt][mt][1] *= corr[1];
      acc[nt][mt][2] *= corr[0];
      acc[nt][mt][3] *= corr[1];
    }
    // P^T as the B operand: the C layout of tokens 0-7 (8-15), transposed.
    b0[nt] = movmatrix_trans(pack2(p0 * vs0, p1 * vs0));
    b1[nt] = movmatrix_trans(pack2(p2 * vs1, p3 * vs1));
  }
  const uint32_t sv = smem_u32(st + L::TILE);
  if constexpr (KV == KV_BF16) {
    // V^T by ldmatrix.trans: 8 x 8 blocks (tokens 0-7 | 8-15) x (dims +0 | +8).
    const uint32_t vaddr =
        sv + (jl + (lane & 7) + (lane >> 4) * 8) * L::RS + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int mt = 0; mt < KT; ++mt) {
      uint32_t m4[4];
      ldsm_x4_trans(m4, vaddr + 32 * mt);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][mt], m4, b0[nt], b1[nt]);
    }
  } else {
    // Raw bytes by ldmatrix.trans as b16 pairs: a thread's register holds
    // dims 2r, 2r + 1 of tokens 2c, 2c + 1, bytes (t 2c: 2r, 2r+1 | t 2c+1:
    // 2r, 2r+1); dim 2r goes to row r of the m-tile, 2r + 1 to row r + 8.
    const uint32_t vaddr =
        sv + (jl + (lane & 7) + ((lane >> 3) & 1) * 8) * L::RS + (lane >> 4) * 16;
#pragma unroll
    for (int x = 0; x < L::RB / 32; ++x) {
      uint32_t m4[4];
      ldsm_x4_trans(m4, vaddr + 32 * x);
      const uint32_t a0[4] = {bytes_bf16x2<KV, 0, 2>(m4[0]), bytes_bf16x2<KV, 1, 3>(m4[0]),
                              bytes_bf16x2<KV, 0, 2>(m4[1]), bytes_bf16x2<KV, 1, 3>(m4[1])};
      const uint32_t a1[4] = {bytes_bf16x2<KV, 0, 2>(m4[2]), bytes_bf16x2<KV, 1, 3>(m4[2]),
                              bytes_bf16x2<KV, 0, 2>(m4[3]), bytes_bf16x2<KV, 1, 3>(m4[3])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(acc[nt][2 * x], a0, b0[nt], b1[nt]);
        mma_bf16(acc[nt][2 * x + 1], a1, b0[nt], b1[nt]);
      }
    }
  }
}

template <int DP, int KV, int NT>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(const __grid_constant__ Args a) {
  using L = Layout<DP, KV, NT>;
  constexpr int KT = DP / 16;
  constexpr int GT = L::GT;
  constexpr int DPT = (DP + THREADS - 1) / THREADS;  // dims a thread takes in the merges
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ Item item;
  __shared__ int last;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * L::STAGE);
  int* rows_s = reinterpret_cast<int*>(full + STAGES);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 2;   // fragment row group
  const int cq = lane & 3;   // and column pair
  const int h = blockIdx.x;
  const int D = a.D;
  const int G = a.G;
  // A split partial: acc [G][D] (padded to 16 bytes), then (m, l) of each head
  // in 2 GT floats.
  const int sa = (G * D + 3) & ~3;
  const int sw = sa + 2 * GT;

  // Warp 0 scans the kv_lens: every group's pages (one group up to MAX_B
  // requests), then the first group's splits.
  ItemScan sc;
  int total = 0;
  if (warp == 0) {
    total = load_group(a, lane, 0, sc);
    if (a.B > MAX_B) total += pages_past_group_0(a, lane);
    split_group(a, lane, total, gridDim.y, 0, 0, sc);
  }
  if (tid == 32) {  // warp 1, while warp 0 scans
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int g = 0;  // ring chunks taken by the block, over all its items
  // Items y = blockIdx.y, + gridDim.y, ...: the grid is one wave of
  // resident blocks, or fewer.
  for (int y = blockIdx.y;; y += gridDim.y) {
    if (warp == 0) {
      seek_group(a, lane, total, gridDim.y, y, true, false, sc);
      Item it;
      const bool mine = lookup_item(a, sc, y, lane, &it);
      const unsigned who = __ballot_sync(0xffffffffu, mine);
      if (mine) item = it;
      if (lane == 0 && who == 0u) item.b = -1;
    }
    __syncthreads();
    if (item.b < 0) break;  // past the last item
    const int b = item.b;
    const int z = item.z;
    const int live = item.live;
    const long long orow = (long long)b * a.Nq + (long long)h * G;  // the group's first head
    const int p0 = z * item.span;  // the split's first page
    const int n_tok = min(item.len - p0 * a.ps, item.span * a.ps);
    const int n_chunks = (n_tok + CH - 1) / CH;
    const int* tb = a.table + (long long)b * a.ppr;
    // The pool row of span token j, -1 past the span.
    auto row_of = [&](int j) {
      if (j >= n_tok) return -1;
      const int pg = div_ps(a, j);
      return tb[min(p0 + pg, a.ppr - 1)] * a.ps + (j - pg * a.ps);
    };
    // q's bf16 pairs as B fragments (k rows = dims, n column = head 8 nt +
    // r), loaded while the page ids are: heads past G and dims past D are
    // zeros. A 1-byte pool's k step permutes its dims as its K fragments do.
    uint32_t qf[NT][KT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int hd = 8 * nt + r;
      const __nv_bfloat16* qrow = a.q + (orow + hd) * D;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int d = KV == KV_BF16 ? 16 * kt + 8 * i + 2 * cq : 16 * kt + 4 * cq + 2 * i;
          qf[nt][kt][i] = hd < G && d < D ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
        }
      }
    }
    // Rows of chunk c in slot c % R of a ring one chunk ahead of the fills:
    // a refill never waits for the page table.
    const int R = STAGES + 1;
    const int nfill = min(STAGES, n_chunks);
    for (int i = tid; i < min(R, n_chunks) * CH; i += THREADS) rows_s[i] = row_of(i);
    __syncthreads();
    for (int c = 0; c < nfill; ++c) {
      const int s = (g + c) % STAGES;
      fill<DP, KV>(a, smem + s * L::STAGE, rows_s + c * CH, &full[s], h, tid);
    }
    // Scaled by sm_scale*log2(e) and rounded to bf16.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t x = qf[nt][kt][i];  // two bf16 as floats: exact
          qf[nt][kt][i] = pack2(__uint_as_float(x << 16) * a.qscale,
                                __uint_as_float(x & 0xFFFF0000u) * a.qscale);
        }
      }
    }

    float acc[NT][KT][4];
    float mrun[NT][2], lrun[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int mt = 0; mt < KT; ++mt)
        acc[nt][mt][0] = acc[nt][mt][1] = acc[nt][mt][2] = acc[nt][mt][3] = 0.f;
      mrun[nt][0] = mrun[nt][1] = NEG;
      lrun[nt][0] = lrun[nt][1] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int s = (g + c) % STAGES;
      const int j0 = c * CH + warp * SUB;
      if (j0 < n_tok) {
        mbar_wait(&full[s], ((g + c) / STAGES) & 1);
        attend<DP, KV, NT>(smem + s * L::STAGE, warp * SUB, j0, n_tok, a.hoff + h, qf, acc,
                           mrun, lrun, lane);
      }
      if (c + STAGES < n_chunks) {  // refill the slot (block-uniform)
        __syncthreads();  // every warp is done with it; the chunk's rows are in
        fill<DP, KV>(a, smem + s * L::STAGE, rows_s + ((c + STAGES) % R) * CH, &full[s], h,
                     tid);
        if (c + STAGES + 1 < n_chunks && tid < CH)  // into chunk c's rows slot
          rows_s[(c % R) * CH + tid] = row_of((c + STAGES + 1) * CH + tid);
      }
    }
    g += n_chunks;

    // Merge the warps that saw a token, in warp order, through the ring.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          lrun[nt][i] += __shfl_xor_sync(0xffffffffu, lrun[nt][i], o);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    float* sm_acc = reinterpret_cast<float*>(smem);  // [WARPS][GT][DP]
    float* sm_m = sm_acc + WARPS * GT * DP;          // [WARPS][GT]
    float* sm_l = sm_m + WARPS * GT;
    const int n_act = min(WARPS, (n_tok + SUB - 1) / SUB);
    if (warp < n_act) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int hd = 8 * nt + 2 * cq;  // this thread's heads hd, hd + 1
        if (r == 0) {
          sm_m[warp * GT + hd] = mrun[nt][0];
          sm_m[warp * GT + hd + 1] = mrun[nt][1];
          sm_l[warp * GT + hd] = lrun[nt][0];
          sm_l[warp * GT + hd + 1] = lrun[nt][1];
        }
#pragma unroll
        for (int mt = 0; mt < KT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sm_acc[(warp * GT + hd + (e & 1)) * DP + acc_dim<KV>(mt, e, r)] = acc[nt][mt][e];
        }
      }
    }
    __syncthreads();
    const long long slot = (long long)(b * a.Hkv + h) * a.s_max;  // the item's first split
    // Thread tid takes dims tid, tid + THREADS, ... of every head.
    for (int u = 0; u < G * DPT; ++u) {
      const int gg = u / DPT;
      const int d = tid + (u % DPT) * THREADS;
      if (d >= D) continue;
      float mw[WARPS], lw[WARPS], aw[WARPS];  // every load before the dependent sums
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        mw[w] = w < n_act ? sm_m[w * GT + gg] : NEG;
        lw[w] = w < n_act ? sm_l[w * GT + gg] : 0.f;
        aw[w] = w < n_act ? sm_acc[(w * GT + gg) * DP + d] : 0.f;
      }
      float M = NEG;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w]);
      float Ls = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if (w < n_act) {
          const float e = ex2(mw[w] - M);
          Ls += lw[w] * e;
          A += aw[w] * e;
        }
      }
      if (live == 1) {
        a.out[(orow + gg) * D + d] = __float2bfloat16(A / fmaxf(Ls, 1e-30f));
        if (d == 0) {
          a.m_out[orow + gg] = M;
          a.l_out[orow + gg] = Ls;
        }
      } else {
        float* part = a.ws + (slot + z) * sw;
        part[gg * D + d] = A;
        if (d == 0) {
          part[sa + 2 * gg] = M;
          part[sa + 2 * gg + 1] = Ls;
        }
      }
    }
    if (live > 1) {
      // The last split of the (request, kv head) to arrive combines all, in
      // split order, from shared memory: every split's (m, l) and as many
      // acc partials as the ring holds copied in one round trip (L2), each
      // head's m, l and split weights, then each output's sum, its terms
      // loaded eight at a time ahead of the dependent adds. Thread 0's
      // fences order the block's partial (seen through the barrier) before
      // its count and the other splits' partials after it.
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        last = atomicAdd(a.counters + b * a.Hkv + h, 1) == live - 1;
        if (last) __threadfence();
      }
      __syncthreads();
      if (last) {
        const float* parts = a.ws + slot * sw;
        float* sml = reinterpret_cast<float*>(smem);  // [live][2 GT]: (m, l), then (weight, l)
        float* shl = sml + live * 2 * GT;               // [2 GT]: each head's l
        float* sacc = shl + 2 * GT;                     // [cap][sa]
        const int cap = (L::RING / 4 - (live + 1) * 2 * GT) / sa;
        for (int i = tid; i < live * (GT / 2); i += THREADS)
          copy_async<16>(sml + 4 * i, parts + (i / (GT / 2)) * sw + sa + 4 * (i % (GT / 2)),
                         true);
        float accv[DPT][GT];
#pragma unroll
        for (int k = 0; k < DPT; ++k)
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) accv[k][gg] = 0.f;
        for (int s0 = 0; s0 < live; s0 += cap) {
          const int n = min(cap, live - s0);
          for (int i = tid; i < n * (sa / 4); i += THREADS) {
            const int sp = i / (sa / 4);
            const int pc = i - sp * (sa / 4);
            copy_async<16>(sacc + sp * sa + 4 * pc, parts + (s0 + sp) * sw + 4 * pc, true);
          }
          asm volatile("cp.async.wait_all;\n" ::: "memory");
          __syncthreads();
          if (s0 == 0) {
            if (tid < G) {  // the head's m and l, the splits' weights
              float* ml = sml + 2 * tid;
              float M = NEG;
              for (int s8 = 0; s8 < live; s8 += 8) {
                float m8[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) m8[i] = s8 + i < live ? ml[(s8 + i) * 2 * GT] : NEG;
#pragma unroll
                for (int i = 0; i < 8; ++i) M = fmaxf(M, m8[i]);
              }
              float Ls = 0.f;
              for (int s8 = 0; s8 < live; s8 += 8) {
                float w[8], l8[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  w[i] = s8 + i < live ? ex2(ml[(s8 + i) * 2 * GT] - M) : 0.f;
                  l8[i] = s8 + i < live ? ml[(s8 + i) * 2 * GT + 1] : 0.f;
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  if (s8 + i < live) {
                    Ls += l8[i] * w[i];
                    ml[(s8 + i) * 2 * GT] = w[i];
                  }
                }
              }
              a.m_out[orow + tid] = M;
              a.l_out[orow + tid] = Ls;
              shl[tid] = Ls;
            }
            __syncthreads();
          }
#pragma unroll
          for (int k = 0; k < DPT; ++k) {
            const int d = tid + k * THREADS;
            if (d >= D) break;
#pragma unroll
            for (int gg = 0; gg < GT; ++gg) {
              if (gg >= G) break;
              float A = accv[k][gg];
              for (int s8 = 0; s8 < n; s8 += 8) {
                float v[8], w[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  v[i] = s8 + i < n ? sacc[(s8 + i) * sa + gg * D + d] : 0.f;
                  w[i] = s8 + i < n ? sml[(s0 + s8 + i) * 2 * GT + 2 * gg] : 0.f;
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) A += v[i] * w[i];  // a zero term past n adds 0
              }
              accv[k][gg] = A;
            }
          }
          __syncthreads();  // before the next group's copies
        }
#pragma unroll
        for (int k = 0; k < DPT; ++k) {
          const int d = tid + k * THREADS;
          if (d >= D) break;
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) {
            if (gg >= G) break;
            a.out[(orow + gg) * D + d] = __float2bfloat16(accv[k][gg] / fmaxf(shl[gg], 1e-30f));
          }
        }
        if (tid == 0) a.counters[b * a.Hkv + h] = 0;  // ready for the next launch
      }
    }
    __syncthreads();  // every thread is done with the item, its slots and `last`
  }
  // Empty requests e = blockIdx.y, + gridDim.y, ...: the empty state, after
  // the items (off their path).
  if (warp == 0) {
    for (int e = blockIdx.y;; e += gridDim.y) {
      seek_group(a, lane, total, gridDim.y, e, false, e == blockIdx.y, sc);
      if (e >= sc.end_e) break;
      const int mine = lookup_empty(sc, e, lane);
      const int src = __ffs(__ballot_sync(0xffffffffu, mine >= 0)) - 1;
      const int b = __shfl_sync(0xffffffffu, mine, src);
      const long long orow = (long long)b * a.Nq + (long long)h * G;
      for (int i = lane; i < G * D; i += 32) a.out[orow * D + i] = __float2bfloat16(0.f);
      if (lane < G) {
        a.m_out[orow + lane] = NEG;
        a.l_out[orow + lane] = 0.f;
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// Opts the instance into its dynamic shared memory, once: before its first
// launch, and before an occupancy query (which reads 0 blocks for an
// instance above the 48 KB default).
template <int DP, int KV, int NT>
int prepare() {
  static bool ready = false;  // per instance
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<DP, KV, NT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Layout<DP, KV, NT>::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  return 0;
}

// Blocks of the instance one SM holds.
template <int DP, int KV, int NT>
int resident_blocks(int* blocks) {
  static int known = 0;  // per instance
  if (known == 0) {
    const int p = prepare<DP, KV, NT>();
    if (p != 0) return p;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &known, paged_decode_kernel<DP, KV, NT>, THREADS, Layout<DP, KV, NT>::BYTES);
    if (e != cudaSuccess) return (int)e;
  }
  *blocks = known;
  return 0;
}

// The grid's y: at most one item per block per wave of resident blocks; a
// block walks items y, y + gridDim.y, ...
template <int DP, int KV, int NT>
int grid_y(const Args& a, int sms, int* ny) {
  int per_sm = 0;
  const int e = resident_blocks<DP, KV, NT>(&per_sm);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)a.B * a.s_max;
  const int wave = max(1, (per_sm * sms + a.Hkv - 1) / a.Hkv);
  *ny = items < wave ? (int)items : wave;
  return 0;
}

template <int DP, int KV, int NT>
int run(const Args& a, cudaStream_t st, int sms) {
  int ny = 0;
  const int e = grid_y<DP, KV, NT>(a, sms, &ny);  // prepares the instance
  if (e != 0) return e;
  paged_decode_kernel<DP, KV, NT>
      <<<dim3(a.Hkv, ny), THREADS, Layout<DP, KV, NT>::BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

// The padded head dim of an instance: a multiple of the mma k step (16) for
// bf16, of an ldmatrix row piece (32 bytes) for 1-byte pools.
int padded_dim(int D, int kv) {
  const int m = kv == KV_BF16 ? 16 : 32;
  return (D + m - 1) / m * m;
}

// The n8 tiles of G query heads.
int n_tiles(int G) { return G > 8 ? 2 : 1; }

// Calls F::template call<DP, KV, NT>() for the instance of padded head dim
// DP (padded_dim) and NT n8 tiles; cudaErrorInvalidValue where there is none.
template <int KV, typename F>
int with_instance(int DP, int NT, F f) {
#define DECODE_DP(P)                                                \
  case P:                                                           \
    return NT == 1 ? f.template call<P, KV, 1>() : f.template call<P, KV, 2>();
  switch (DP) {
    DECODE_DP(32)
    DECODE_DP(64)
    DECODE_DP(96)
    DECODE_DP(128)
    DECODE_DP(256)
  }
  if constexpr (KV == KV_BF16) {
    switch (DP) {
      DECODE_DP(16)
      DECODE_DP(48)
      DECODE_DP(80)
      DECODE_DP(112)
    }
  }
#undef DECODE_DP
  return (int)cudaErrorInvalidValue;
}

struct RunInstance {
  const Args& a;
  cudaStream_t st;
  int sms;
  template <int DP, int KV, int NT>
  int call() const { return run<DP, KV, NT>(a, st, sms); }
};

struct SmemOf {
  template <int DP, int KV, int NT>
  int call() const { return Layout<DP, KV, NT>::BYTES; }
};

struct GridOf {
  const Args& a;
  int sms;
  int* ny;
  template <int DP, int KV, int NT>
  int call() const { return grid_y<DP, KV, NT>(a, sms, ny); }
};

// Head dims the kernel takes: every even one from 16 to 128, and 256.
bool head_dim_ok(int D) { return D % 2 == 0 && ((D >= 16 && D <= 128) || D == 256); }

template <int KV>
int launch(Args a, void* stream) {
  constexpr int EB = KV == KV_BF16 ? 2 : 1;
  if (a.Hkv <= 0 || a.Nq % a.Hkv != 0 || a.Nq / a.Hkv > MAX_G) return (int)cudaErrorInvalidValue;
  if (!head_dim_ok(a.D)) return (int)cudaErrorInvalidValue;
  if (a.B <= 0 || a.ps <= 0 || a.ppr <= 0) return (int)cudaErrorInvalidValue;
  if (a.s_max < 1 || a.s_max > MAX_SPLITS || a.min_span < 1) return (int)cudaErrorInvalidValue;
  if (a.s_max > 1 && (a.ws == nullptr || a.counters == nullptr)) return (int)cudaErrorInvalidValue;
  // The reciprocal divides exactly every token index j of a split (j * ps <
  // 2^32), and a length packs into 24 bits beside its split count.
  if ((long long)a.ppr * a.ps * a.ps >= (1LL << 32) || (long long)a.ppr * a.ps >= (1 << 24))
    return (int)cudaErrorInvalidValue;
  if (KV == KV_INT8 && (a.scales == nullptr || a.hoff < 0 || a.hoff + a.Hkv > SCALE_LANES / 2 ||
                        !aligned(a.scales, 4)))
    return (int)cudaErrorInvalidValue;
  a.G = a.Nq / a.Hkv;
  a.ps_recip = ((1ULL << 32) + a.ps - 1) / a.ps;
  // The widest copy up to 16 bytes that divides a row and that the pool's
  // alignment allows (bf16: at least 4, D being even).
  a.ub = 16;
  while (a.ub > 2 && ((EB * a.D) % a.ub != 0 || !aligned(a.pages, a.ub))) a.ub /= 2;
  if ((EB * a.D) % a.ub != 0 || !aligned(a.pages, a.ub) || (KV == KV_BF16 && a.ub < 4) ||
      !aligned(a.q, 4))
    return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  return with_instance<KV>(padded_dim(a.D, KV), n_tiles(a.G),
                           RunInstance{a, static_cast<cudaStream_t>(stream), sms});
}

// An instance query by pool type kv (0 bf16, 1 int8, 2 fp8).
template <typename F>
int by_kv(int kv, int DP, int NT, F f) {
  switch (kv) {
    case KV_BF16: return with_instance<KV_BF16>(DP, NT, f);
    case KV_INT8: return with_instance<KV_INT8>(DP, NT, f);
    case KV_FP8: return with_instance<KV_FP8>(DP, NT, f);
  }
  return -1;
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory (bytes) of the instance for head dim D, pool type kv
// (0 bf16, 1 int8, 2 fp8) and G query heads per kv head, or -1.
extern "C" int paged_decode_smem(int D, int kv, int G) {
  if (!head_dim_ok(D) || G < 1 || G > MAX_G) return -1;
  const int bytes = by_kv(kv, padded_dim(D, kv), n_tiles(G), SmemOf{});
  return bytes == (int)cudaErrorInvalidValue ? -1 : bytes;
}

// The grid's y of a launch (the resident blocks per SM queried on the
// current device), or -1.
extern "C" int paged_decode_grid_y(int D, int kv, int B, int Hkv, int s_max, int G) {
  Args a{};
  a.B = B;
  a.Hkv = Hkv;
  a.s_max = s_max;
  int dev = 0, sms = 0, ny = -1;
  if (!head_dim_ok(D) || G < 1 || G > MAX_G || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int e = by_kv(kv, padded_dim(D, kv), n_tiles(G), GridOf{a, sms, &ny});
  return e == 0 ? ny : -1;
}

// kv_lens: tokens present in the pool per request (the caller passes
// seq_len - 1 when the newest token rides separately). scales: the int8
// pool's merged [L, T, 128] bf16 slab, null for bf16 and fp8 pools. ws /
// counters: the split workspace of the stream (counters 0), unused when
// s_max is 1. s_max and min_span (pages): ops/attention_decode.py
// plan_decode_splits. head_offset: the first global kv head of the pool's
// tensor-parallel shard, which shifts the int8 scale lanes (other pools
// ignore it).
#define PAGED_DECODE_ENTRY(NAME, KV)                                                           \
  extern "C" int NAME(const void* q, const void* pages, const void* scales,                    \
                      const void* page_table, const void* kv_lens, void* out, void* m, void* l, \
                      void* ws, void* counters, int B, int Nq, int Hkv, int D, long long T,    \
                      int layer, int ps, int ppr, float qscale, int s_max, int min_span,       \
                      int head_offset, void* stream) {                                         \
    Args a{};                                                                                  \
    a.q = static_cast<const __nv_bfloat16*>(q);                                                \
    a.pages = static_cast<const uint8_t*>(pages);                                              \
    a.scales = static_cast<const __nv_bfloat16*>(scales);                                      \
    a.table = static_cast<const int*>(page_table);                                             \
    a.kv_lens = static_cast<const int*>(kv_lens);                                              \
    a.out = static_cast<__nv_bfloat16*>(out);                                                  \
    a.m_out = static_cast<float*>(m);                                                          \
    a.l_out = static_cast<float*>(l);                                                          \
    a.ws = static_cast<float*>(ws);                                                            \
    a.counters = static_cast<int*>(counters);                                                  \
    a.B = B;                                                                                   \
    a.Nq = Nq;                                                                                 \
    a.Hkv = Hkv;                                                                               \
    a.D = D;                                                                                   \
    a.T = T;                                                                                   \
    a.layer = layer;                                                                           \
    a.ps = ps;                                                                                 \
    a.ppr = ppr;                                                                               \
    a.qscale = qscale;                                                                         \
    a.s_max = s_max;                                                                           \
    a.min_span = min_span;                                                                     \
    a.hoff = KV == KV_INT8 ? head_offset : 0;                                                  \
    return launch<KV>(a, stream);                                                              \
  }

PAGED_DECODE_ENTRY(paged_decode_bf16, KV_BF16)
PAGED_DECODE_ENTRY(paged_decode_int8, KV_INT8)
PAGED_DECODE_ENTRY(paged_decode_fp8, KV_FP8)
