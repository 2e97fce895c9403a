// Ragged causal GQA flash attention (fresh prefill, no history) for Hopper
// (sm_90a): K2 and K8, one kernel template, as the TPU has one
// _prefill_kernel for its streamed forms. The chunked form over the paged
// pool's history (K5 / K5q) is csrc/flash_prefill_chunked.cu.
//
// Replaces the TPU kernels of lite_llama_tpu/ops/attention_prefill.py:
// - K2, flash_prefill -> _flash_prefill_impl / _prefill_kernel
//   (has_history=False): causal attention over a padded [B, S] batch with
//   per-request lengths; padded keys are masked and padded query rows are
//   never read by any caller. Head dims 64 and 128.
// - K8, flash_prefill -> _flash_prefill_vmem / _prefill_kernel_vmem: the
//   same function for head dims the TPU cannot pack into 128 lanes (D = 80,
//   96, 100, ...). Here it is the padded instance of the template below, for
//   every even D from 16 to 128 other than 64 and 128. The TPU kernel keeps
//   the whole key stream of a head in VMEM (capped near S ~ 8k); this one
//   streams 64-key tiles like K2 and has no such cap.
// Query head n attends kv head n // G in both.
//
// What bounds them: tensor-core operations once prompts are long, about
// 4 * Nq * D * sum_b(len_b^2 / 2) FLOPs against 989 TFLOP/s in bf16; for
// short ones the bytes of q, k, v and out against 3.35 TB/s.
//
// Design:
// - Grid (q tile, kv head, request). A block holds the G query heads of one
//   kv head: warp w computes 16 query rows of head w / QW, QW = 8 / G warps
//   per head, so one BK x DP tile of K and V in shared memory serves all
//   G * 16 * QW query rows of the group.
// - Head dims: one template over the padded width DP = round_up(D, 16), the
//   mma k-step, with the true D a runtime argument (EXACT instances, D = DP
//   = 64 or 128, know it at compile time and are K2's original code). Q
//   fragments and the K/V tiles hold zeros in lanes D..DP-1, so the QK
//   product is exact; the PV product runs DP/8 n-tiles and columns >= D are
//   never stored. A head starts at byte 2 * h * D, which for D = 100 is only
//   8-byte aligned, so tile loads move VEC = 8, 4 or 2 values (the largest
//   power of two dividing D that the pointers' alignment allows) instead of
//   always 16 bytes.
// - QK^T and PV run on the tensor cores through mma.sync m16n8k16
//   (bf16 inputs, fp32 accumulate). The score fragment is rounded to bf16
//   and reused in registers as the A operand of the PV product (as the TPU
//   kernel rounds P before its PV dot); the row sums l use the unrounded P.
// - fp32 online softmax in the exp2 domain, sm_scale*log2(e) folded into q
//   (rounded to bf16 after the scale, as the streamed TPU kernel does; its
//   VMEM form keeps q in fp32, a difference of one bf16 step at most).
// - The causal mask and the ragged length mask are applied per tile; key
//   tiles above a warp's diagonal are skipped, key tiles past the causal
//   frontier or past the length are never loaded.
// - Head packing for D=64 (a TPU 128-lane DMA device) is not carried over:
//   D = 64 and D = 128 are template instances.
// Simple first: one K/V buffer, no cp.async/TMA pipelining, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;    // keys per tile
constexpr int KPAD = 8;   // shared-memory row padding (bf16) against bank conflicts
constexpr int MAX_WARPS = 8;
constexpr int MAX_D = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one bf16x2 register; the first goes to the low half (the
// lower column / k index of an mma fragment).
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// VEC bf16 values moved as one load or store: 16, 8 or 4 bytes.
template <int VEC>
struct Vec;
template <>
struct Vec<8> {
  using T = uint4;
};
template <>
struct Vec<4> {
  using T = uint2;
};
template <>
struct Vec<2> {
  using T = uint32_t;
};

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// One warp's 16 query rows against one BK-key tile in shared memory:
// scores, mask, online-softmax update, PV. CAUSAL: key j0 + i is visible to
// row p iff it is <= p and < limit.
template <int DP>
__device__ __forceinline__ void attend_tile(const uint32_t (&qa)[DP / 16][4],
                                            float (&o)[DP / 8][4], float (&mrow)[2],
                                            float (&lrow)[2], const __nv_bfloat16* sK,
                                            const __nv_bfloat16* sV, int j0, int limit, int p0,
                                            int r, int c) {
  constexpr int KS = DP + KPAD;
  constexpr int KT = DP / 16;
  constexpr int DT = DP / 8;
  float s[BK / 8][4];
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const __nv_bfloat16* kp = &sK[(nt * 8 + r) * KS + kk * 16 + 2 * c];
      mma_16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                *reinterpret_cast<const uint32_t*>(kp + 8));
    }
  }

  float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j0 + nt * 8 + 2 * c + (e & 1);
      const int prow = p0 + r + ((e & 2) ? 8 : 0);
      const bool ok = key <= prow && key < limit;
      s[nt][e] = ok ? s[nt][e] : NEG;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
  float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = exp2f(mrow[i] - mx[i]);
    mrow[i] = mx[i];
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = s[nt][e] > 0.5f * NEG ? exp2f(s[nt][e] - mrow[e >> 1]) : 0.f;
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
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t pa[4] = {
        pack2(s[2 * kk][0], s[2 * kk][1]), pack2(s[2 * kk][2], s[2 * kk][3]),
        pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]), pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const __nv_bfloat16* vp = &sV[(kk * 16 + 2 * c) * KS + dt * 8 + r];
      mma_16816(o[dt], pa, pack_raw(vp[0], vp[KS]), pack_raw(vp[8 * KS], vp[9 * KS]));
    }
  }
}

// One BK x DP tile of K and V into shared memory, VEC values per load;
// rows at or past kv_hi and lanes D..DP-1 are zeros.
template <int DP, bool EXACT, int VEC>
__device__ __forceinline__ void kv_tile(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                           const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                           long long ks, int j0, int kv_hi, int D) {
  using T = typename Vec<VEC>::T;
  constexpr int KS = DP + KPAD;
  constexpr int NCH = DP / VEC;  // loads per tile row
  for (int idx = threadIdx.x; idx < BK * NCH; idx += blockDim.x) {
    const int row = idx / NCH;
    const int ch = (idx % NCH) * VEC;
    const int pos = j0 + row;
    T kv{}, vv{};
    if (pos < kv_hi && (EXACT || ch < D)) {
      kv = *reinterpret_cast<const T*>(kb + pos * ks + ch);
      vv = *reinterpret_cast<const T*>(vb + pos * ks + ch);
    }
    *reinterpret_cast<T*>(&sK[row * KS + ch]) = kv;
    *reinterpret_cast<T*>(&sV[row * KS + ch]) = vv;
  }
}

template <int DP, bool EXACT>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,      // [B, S, Nq, D]
                     const __nv_bfloat16* __restrict__ k,      // [B, S, Hkv, D]
                     const __nv_bfloat16* __restrict__ v,      // [B, S, Hkv, D]
                     const int* __restrict__ seq_lens,         // [B]
                     __nv_bfloat16* __restrict__ out,          // [B, S, Nq, D]
                     int S, int Nq, int Hkv, int head_dim, int vec, int QW, float qscale) {
  constexpr int KS = DP + KPAD;  // shared-memory row stride
  constexpr int KT = DP / 16;    // k-steps of the QK product
  constexpr int DT = DP / 8;     // n-tiles of the PV product
  const int D = EXACT ? DP : head_dim;  // the true head dim; lanes D..DP-1 are padding
  // Raw 16-bit storage: a __shared__ array of a class type is not portable.
  __shared__ __align__(16) unsigned short sK_raw[BK * KS];
  __shared__ __align__(16) unsigned short sV_raw[BK * KS];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(sK_raw);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sV_raw);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Nq / Hkv;
  const int BQ = 16 * QW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = h * G + warp / QW;      // this warp's query head
  const int q0 = qt * BQ;               // first position of the q tile
  const int p0 = q0 + (warp % QW) * 16; // first position of this warp's rows
  const int r = lane >> 2;              // fragment row group
  const int c = lane & 3;               // fragment column pair
  const int len = seq_lens[b];
  const long long qs = (long long)Nq * D;   // position stride of q / out
  const long long ks = (long long)Hkv * D;  // position stride of k / v
  __nv_bfloat16* ob = out + (long long)b * S * qs + (long long)n * D;

  if (q0 >= len) {  // a q tile wholly past the request's length is padding
    for (int i = lane; i < 16 * D; i += 32) {
      const int pos = p0 + i / D;
      if (pos < S) ob[pos * qs + i % D] = __float2bfloat16(0.f);
    }
    return;
  }

  // This warp's 16 query rows as A fragments, scaled and rounded to bf16;
  // lanes D..DP-1 are zeros.
  const __nv_bfloat16* qb = q + (long long)b * S * qs + (long long)n * D;
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pos = p0 + r + ((j & 1) ? 8 : 0);
      const int d = kk * 16 + 2 * c + ((j & 2) ? 8 : 0);
      float2 f = make_float2(0.f, 0.f);
      if (pos < S && (EXACT || d < D))
        f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qb + pos * qs + d));
      qa[kk][j] = pack2(f.x * qscale, f.y * qscale);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float mrow[2] = {NEG, NEG};
  float lrow[2] = {0.f, 0.f};

  const int kv_hi = min(q0 + BQ, len);  // keys any row of this tile may see
  const int n_tiles = kv_hi > 0 ? (kv_hi + BK - 1) / BK : 0;
  const __nv_bfloat16* kb = k + (long long)b * S * ks + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * S * ks + (long long)h * D;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    if constexpr (EXACT) {
      kv_tile<DP, true, 8>(sK, sV, kb, vb, ks, j0, kv_hi, D);
    } else if (vec == 8) {
      kv_tile<DP, false, 8>(sK, sV, kb, vb, ks, j0, kv_hi, D);
    } else if (vec == 4) {
      kv_tile<DP, false, 4>(sK, sV, kb, vb, ks, j0, kv_hi, D);
    } else {
      kv_tile<DP, false, 2>(sK, sV, kb, vb, ks, j0, kv_hi, D);
    }
    __syncthreads();
    if (j0 > p0 + 15) continue;  // tile entirely above this warp's diagonal
    attend_tile<DP>(qa, o, mrow, lrow, sK, sV, j0, len, p0, r, c);
  }

  float lt[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lt[i] = lrow[i];
    lt[i] += __shfl_xor_sync(0xffffffffu, lt[i], 1);
    lt[i] += __shfl_xor_sync(0xffffffffu, lt[i], 2);
    inv[i] = 1.f / fmaxf(lt[i], 1e-30f);
  }
  const int pr0 = p0 + r;
  const int pr1 = p0 + r + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + 2 * c;
    if (!EXACT && d >= D) continue;  // a padding column: never stored
    if (pr0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + pr0 * qs + d) =
          __floats2bfloat162_rn(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    if (pr1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + pr1 * qs + d) =
          __floats2bfloat162_rn(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// padded: K8's instances, the padded template even where D = DP; otherwise
// D = 64 and 128 take the EXACT instances (K2).
int launch(const void* q, const void* k, const void* v, const void* seq_lens, void* out, int B,
           int S, int Nq, int Hkv, int D, bool padded, float qscale, void* stream) {
  if (Hkv <= 0 || Nq % Hkv != 0 || Nq / Hkv > MAX_WARPS) return (int)cudaErrorInvalidValue;
  if (D <= 0 || D > MAX_D || D % 2 != 0) return (int)cudaErrorInvalidValue;
  // Values per tile load: the largest power of two up to 8 that divides D
  // and that the K/V pointers' alignment allows.
  int vec = 8;
  while (vec > 2 && (D % vec != 0 || !aligned(k, 2 * vec) || !aligned(v, 2 * vec))) vec /= 2;
  if (!aligned(q, 4) || !aligned(k, 2 * vec) || !aligned(v, 2 * vec))
    return (int)cudaErrorMisalignedAddress;
  const bool exact = !padded && (D == 64 || D == 128);
  if (exact && vec != 8) return (int)cudaErrorMisalignedAddress;
  const int G = Nq / Hkv;
  const int QW = MAX_WARPS / G;  // warps (16-row slices) per query head
  const int BQ = 16 * QW;
  const dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  const dim3 block(32 * G * QW);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* sl = static_cast<const int*>(seq_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
#define PREFILL_INSTANCE(DP, EXACT)                                                       \
  flash_prefill_kernel<DP, EXACT><<<grid, block, 0, st>>>(qp, kp, vp, sl, op, S, Nq, Hkv, D, \
                                                          vec, QW, qscale)
  if (exact && D == 128) {
    PREFILL_INSTANCE(128, true);
  } else if (exact) {
    PREFILL_INSTANCE(64, true);
  } else {
    switch ((D + 15) / 16 * 16) {  // DP: D padded to the mma k-step
      case 16: PREFILL_INSTANCE(16, false); break;
      case 32: PREFILL_INSTANCE(32, false); break;
      case 48: PREFILL_INSTANCE(48, false); break;
      case 64: PREFILL_INSTANCE(64, false); break;
      case 80: PREFILL_INSTANCE(80, false); break;
      case 96: PREFILL_INSTANCE(96, false); break;
      case 112: PREFILL_INSTANCE(112, false); break;
      default: PREFILL_INSTANCE(128, false); break;
    }
  }
#undef PREFILL_INSTANCE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2: fresh prefill, no history, head dims 64 and 128.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* seq_lens, void* out, int B, int S, int Nq,
                                  int Hkv, int D, float qscale, void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, seq_lens, out, B, S, Nq, Hkv, D, false, qscale, stream);
}

// K8: fresh prefill through the padded instances, any even head dim up to
// 128 (the callers send it the dims other than 64 and 128).
extern "C" int flash_prefill_vmem_bf16(const void* q, const void* k, const void* v,
                                       const void* seq_lens, void* out, int B, int S, int Nq,
                                       int Hkv, int D, float qscale, void* stream) {
  return launch(q, k, v, seq_lens, out, B, S, Nq, Hkv, D, true, qscale, stream);
}
