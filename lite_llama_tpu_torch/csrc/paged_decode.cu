// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel lite_llama_tpu/ops/attention_decode.py
// paged_flash_decode / _decode_kernel: decode-step attention, one query token
// per request, reading K/V straight out of the paged pool
// [L, 2, T, Hkv*D] (K/V planes, flat token rows, head-major channels) through
// the page table, and returning the online-softmax state (m, l) in the exp2
// domain beside the normalised output, so that the caller can fold in the
// newest token (ops/ref.py fold_new_token).
//
// What bounds it: device-memory bytes. Every K and V row of every live token
// is read once, B * kv_len * 2 * Hkv * D * 2 bytes, against a few FLOPs per
// byte; the H100 runs out of bandwidth long before it runs out of arithmetic.
//
// Design:
// - One block per (kv head, request). The G = Nq / Hkv query heads of the
//   group live in registers of every warp, so each K/V row is loaded once
//   and used G times.
// - A warp owns whole tokens: its 32 lanes split one head row and reduce
//   the G dot products with shuffles. A lane holds NV values in groups of
//   VW consecutive ones (8- or 4-byte loads, neighbouring lanes on
//   neighbouring addresses): group j of lane t starts at value VW*(t + 32j).
//   D = 128 and D = 64 are the EXACT instances (NV = VW = D/32, one load a
//   lane). Any other even D up to 128 takes a padded instance with D a
//   runtime argument, where groups at or past D are masked lanes: NV = 2
//   for D <= 64, else NV = 4 with VW = 4 where D % 4 == 0 (D = 80, 96, 100:
//   a head starts at 2 * h * D bytes, 8-byte aligned) and VW = 2 otherwise
//   (D = 98: only 4-byte aligned), so no load is wider than the alignment.
//   Eight warps take tokens round robin, UNR tokens each per iteration, so
//   8 * UNR rows per block are in flight to hide device-memory latency.
// - The block resolves its own pages through the page table (no
//   prefetched index list) and handles any page_size.
// - Each warp keeps an fp32 online softmax (m, l, acc) per query head in the
//   exp2 domain with sm_scale*log2(e) folded into q (q rounded to bf16 after
//   the scale, as on the TPU); P is rounded to bf16 before the PV product and
//   the row sum l takes the unrounded P (the TPU kernel's p_v.astype and
//   sum); the eight partial states are merged through shared memory at the
//   end.
// - An empty slot (kv_len 0) writes m = -1e30, l = 0, out = 0, so that the
//   fold returns the new token's value exactly.
// - K1q, the quantized pools of the same TPU kernel (the quantized=True
//   branch and the fp8 cast of its page tiles), are instances of this kernel
//   templated on the pool type. An int8 pool carries per-(token, head) bf16
//   scales in a merged [L, T, 128] slab (K in lane h, V in lane 64 + h); they
//   are applied in the score domain as on the TPU: s = (q . k_int) * k_scale,
//   l sums the unscaled P, and PV takes bf16(P * v_scale) against the integer
//   V values. An fp8 e4m3 pool converts to bf16 exactly and is otherwise the
//   bf16 path. A lane loads D/32 bytes of a quantized row instead of D/16, so
//   the same bytes bound holds at half (int8 adds 4 scale bytes per token
//   and head).
// Not carried over from the TPU: the wide/grouped MXU forms, the cross-program
// DMA lookahead and the 128-lane m/l outputs (TPU layout devices).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;   // query heads per kv head
constexpr int UNR = 4;     // tokens per warp per iteration
constexpr float NEG = -1e30f;

enum KvType { KV_BF16 = 0, KV_INT8 = 1, KV_FP8 = 2 };

__device__ __forceinline__ float fp8_to_float(uint32_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(v);
}

// VPL consecutive 1-byte pool values as floats (exact for int8 and e4m3).
template <int VPL, int KV>
__device__ __forceinline__ void load_bytes(const uint8_t* p, float* f) {
  const uint32_t raw = VPL == 4 ? *reinterpret_cast<const uint32_t*>(p)
                                : (uint32_t)*reinterpret_cast<const uint16_t*>(p);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const uint32_t b = (raw >> (8 * i)) & 0xFFu;
    f[i] = KV == KV_INT8 ? (float)(int8_t)b : fp8_to_float(b);
  }
}

template <int VPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* f) {
  if constexpr (VPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  } else {
    static_assert(VPL == 2, "a lane loads 2 or 4 values at a time");
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    f[0] = a.x; f[1] = a.y;
  }
}

// NV values per lane in groups of VW; DC the head dim when it is a
// compile-time constant (the EXACT instances, DC = 32 * NV), else 0.
template <int NV, int VW, int DC, int KV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,       // [B, Nq, D]
                    const void* __restrict__ pages,            // [L, 2, T, Hkv*D]
                    const __nv_bfloat16* __restrict__ scales,  // [L, T, 128] (int8 only)
                    const int* __restrict__ page_table,        // [B, ppr]
                    const int* __restrict__ kv_lens,           // [B]
                    __nv_bfloat16* __restrict__ out,           // [B, Nq, D]
                    float* __restrict__ m_out,                 // [B, Nq]
                    float* __restrict__ l_out,                 // [B, Nq]
                    int Nq, int Hkv, int head_dim, long long T, int layer, int ps, int ppr,
                    float qscale) {
  constexpr int NG = NV / VW;   // value groups per lane
  constexpr int DMAX = 32 * NV; // widest head this instance covers
  constexpr bool EXACT = DC == DMAX;
  constexpr int EB = KV == KV_BF16 ? 2 : 1;  // bytes per pool value
  const int D = DC ? DC : head_dim;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Nq / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long HD = (long long)Hkv * D;
  const int len = kv_lens[b];
  const int* pt = page_table + (long long)b * ppr;
  int goff[NG];   // first value of each of this lane's groups
  bool gok[NG];   // the group lies inside the head (always, when EXACT)
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    goff[j] = VW * (lane + 32 * j);
    gok[j] = EXACT || goff[j] < D;
  }
  const uint8_t* kbase = static_cast<const uint8_t*>(pages) +
                         EB * ((long long)layer * 2 * T * HD + (long long)h * D);
  const uint8_t* vbase = kbase + EB * T * HD;
  const __nv_bfloat16* sbase = KV == KV_INT8 ? scales + (long long)layer * T * 128 + h : nullptr;

  float qf[MAX_G][NV];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    float t[NV];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if (g < G && gok[j]) {
        load_row<VW>(q + ((long long)b * Nq + h * G + g) * D + goff[j], t + j * VW);
      } else {
#pragma unroll
        for (int i = 0; i < VW; ++i) t[j * VW + i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
      qf[g][i] = __bfloat162float(__float2bfloat16(t[i] * qscale));
  }

  float m[MAX_G], l[MAX_G], acc[MAX_G][NV];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[g][i] = 0.f;
  }

  // len is uniform over the block, so every branch below is warp-uniform
  // (gok differs between lanes only around a load).
  for (int t0 = warp * UNR; t0 < len; t0 += WARPS * UNR) {
    float kf[UNR][NV], vf[UNR][NV], ksc[UNR], vsc[UNR];
    bool ok[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int t = t0 + u;
      ok[u] = t < len;
      ksc[u] = vsc[u] = 1.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) kf[u][i] = vf[u][i] = 0.f;
      if (ok[u]) {
        const long long row = (long long)pt[t / ps] * ps + (t % ps);
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          if (!gok[j]) continue;
          const long long off = EB * (row * HD + goff[j]);
          if (KV == KV_BF16) {
            load_row<VW>(reinterpret_cast<const __nv_bfloat16*>(kbase + off), kf[u] + j * VW);
            load_row<VW>(reinterpret_cast<const __nv_bfloat16*>(vbase + off), vf[u] + j * VW);
          } else {
            load_bytes<VW, KV>(kbase + off, kf[u] + j * VW);
            load_bytes<VW, KV>(vbase + off, vf[u] + j * VW);
          }
        }
        if (KV == KV_INT8) {
          ksc[u] = __bfloat162float(sbase[row * 128]);
          vsc[u] = __bfloat162float(sbase[row * 128 + 64]);
        }
      }
    }
    float s[UNR][MAX_G];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) a += qf[g][i] * kf[u][i];
        s[u][g] = a;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
        }
      }
    }
    if (KV == KV_INT8) {  // K dequant in the score domain
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) s[u][g] *= ksc[u];
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        float mx = NEG;
#pragma unroll
        for (int u = 0; u < UNR; ++u)
          if (ok[u]) mx = fmaxf(mx, s[u][g]);
        const float m_new = fmaxf(m[g], mx);
        const float corr = exp2f(m[g] - m_new);
        float p[UNR];
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const float pu = ok[u] ? exp2f(s[u][g] - m_new) : 0.f;
          psum += pu;  // l sums the unrounded P, as the TPU kernel does
          // P in bf16 for PV; an int8 pool folds the V scale into it first.
          p[u] = __bfloat162float(__float2bfloat16(KV == KV_INT8 ? pu * vsc[u] : pu));
        }
        l[g] = l[g] * corr + psum;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float a = acc[g][i] * corr;
#pragma unroll
          for (int u = 0; u < UNR; ++u) a += p[u] * vf[u][i];
          acc[g][i] = a;
        }
        m[g] = m_new;
      }
    }
  }

  // Merge the eight warps' partial states.
  __shared__ float sm_m[WARPS][MAX_G];
  __shared__ float sm_l[WARPS][MAX_G];
  __shared__ float sm_acc[WARPS][MAX_G][DMAX];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        if (!gok[j]) continue;
#pragma unroll
        for (int i = 0; i < VW; ++i) sm_acc[warp][g][goff[j] + i] = acc[g][j * VW + i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D;
    const int d = idx % D;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f(sm_m[w][g] - M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    const long long o = (long long)b * Nq + h * G + g;
    out[o * D + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    if (d == 0) {
      m_out[o] = M;
      l_out[o] = L;
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

template <int KV>
int launch(const void* q, const void* pages, const void* scales, const void* page_table,
           const void* kv_lens, void* out, void* m, void* l, int B, int Nq, int Hkv, int D,
           long long T, int layer, int ps, int ppr, float qscale, void* stream) {
  constexpr int EB = KV == KV_BF16 ? 2 : 1;  // bytes per pool value
  if (Hkv <= 0 || Nq % Hkv != 0 || Nq / Hkv > MAX_G) return (int)cudaErrorInvalidValue;
  if (D <= 0 || D > 128 || D % 2 != 0) return (int)cudaErrorInvalidValue;
  if (KV == KV_INT8 && (scales == nullptr || Hkv > 64)) return (int)cudaErrorInvalidValue;
  // Values per load (VW): 4 where D % 4 == 0 and D > 64, else 2.
  const int vw = (D > 64 && D % 4 == 0) ? 4 : 2;
  if (!aligned(q, 2 * vw) || !aligned(pages, EB * vw)) return (int)cudaErrorMisalignedAddress;
  const dim3 grid(Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* tp = static_cast<const int*>(page_table);
  const auto* lp = static_cast<const int*>(kv_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* mp = static_cast<float*>(m);
  auto* lo = static_cast<float*>(l);
#define DECODE_INSTANCE(NV, VW, DC)                                                          \
  paged_decode_kernel<NV, VW, DC, KV><<<grid, THREADS, 0, st>>>(qp, pages, sp, tp, lp, op, mp, \
                                                                 lo, Nq, Hkv, D, T, layer, ps, \
                                                                 ppr, qscale)
  if (D == 128) {
    DECODE_INSTANCE(4, 4, 128);
  } else if (D == 64) {
    DECODE_INSTANCE(2, 2, 64);
  } else if (D < 64) {
    DECODE_INSTANCE(2, 2, 0);
  } else if (vw == 4) {
    DECODE_INSTANCE(4, 4, 0);
  } else {
    DECODE_INSTANCE(4, 2, 0);
  }
#undef DECODE_INSTANCE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// kv_lens: tokens present in the pool per request (the caller passes
// seq_len - 1 when the newest token rides separately). scales: the int8
// pool's merged [L, T, 128] bf16 slab, null for bf16 and fp8 pools. Any
// even head dim up to 128.
#define PAGED_DECODE_ENTRY(NAME, KV)                                                          \
  extern "C" int NAME(const void* q, const void* pages, const void* scales,                   \
                      const void* page_table, const void* kv_lens, void* out, void* m, void* l, \
                      int B, int Nq, int Hkv, int D, long long T, int layer, int ps, int ppr,  \
                      float qscale, void* stream) {                                            \
    return launch<KV>(q, pages, scales, page_table, kv_lens, out, m, l, B, Nq, Hkv, D, T,     \
                      layer, ps, ppr, qscale, stream);                                         \
  }

PAGED_DECODE_ENTRY(paged_decode_bf16, KV_BF16)
PAGED_DECODE_ENTRY(paged_decode_int8, KV_INT8)
PAGED_DECODE_ENTRY(paged_decode_fp8, KV_FP8)
