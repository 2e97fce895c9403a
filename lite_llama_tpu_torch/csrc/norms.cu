// Fused residual-add + RMSNorm (K3) and SwiGLU (K4) for Hopper (sm_90a).
// Either may also write, in the same pass, the per-row int8 rows and fp32
// row scales that the W4A8 matmul K6 takes (csrc/qmatmul.cu qmm_w4a8).
//
// Replaces the TPU kernels of lite_llama_tpu/ops/norms.py:
// - rms_norm :61 (pallas_call :65) and skip_rms_norm :83 (pallas_call :90):
//   K3, rows_kernel<OP_RMS> (a null residual is rms_norm);
// - swiglu :115 (pallas_call :120): K4, swiglu_kernel, or rows_kernel<
//   OP_SWIGLU> where it writes int8 rows (they need each row's max).
// The JAX model path leaves these to XLA, which fuses them into their
// neighbours. Eager PyTorch fuses nothing, so here they run on every layer:
// two K3 and one K4 per layer of each decode step or prefill, and the final
// norm.
//
// Numerics follow ops/ref.py, which is what the JAX main path runs. K3
// rounds x + residual to the activation dtype; that rounded sum is the new
// residual and is what is normalised, in fp32: y = s * rsqrt(mean(s^2) +
// eps) * w, rounded once. (The TPU kernel normalises the unrounded fp32 sum;
// the two agree in fp32.) K4 is (g * sigmoid(g)) * u in fp32, rounded once.
// The int8 rows come from the rounded outputs, through K6's own rounding
// (common.cuh quant_scale / quant_int8), so K6 fed by them equals K6 fed by
// the outputs, bit for bit.
//
// What bounds each width, and what the design does about it:
// - Decode (12 to 64 rows): launch latency and each thread's instruction
//   chain. K3's bytes at [12, 3072] with its residual (0.15 MB) take 0.04
//   us at 3.35 TB/s; a launch and a chain of dependent DRAM round trips
//   take microseconds, and with a few warps an SM each instruction of the
//   chain adds its latency. So:
//   * each kernel makes the programmatic-dependent-launch (PDL) handshake
//     (common.cuh): griddepcontrol.wait right before the first read of the
//     predecessor's output (the norm weight's loads fly before it) and
//     launch_dependents right after it, so that a matmul launched behind
//     as a programmatic dependent (K6's split grids, K7) fetches its first
//     weights while the norm runs: K6 fed by K3 / K4's int8 rows keeps the
//     overlap its own quantizer gave it. K3 / K4 themselves launch without
//     the PDL attribute: back to back it made them ~1 us faster, but in a
//     decode layer's real sequence (chip_smoke.py chain_case, an H100) it
//     cost ~0.8 us a layer behind cuBLAS's matmuls and gained nothing
//     behind K6's (PERF.md);
//   * each thread issues all its 16-byte loads (row, residual, weight)
//     before the reduction and keeps the row in registers: one round trip;
//   * the reduction is one warp shuffle and one shared-memory step, over
//     up to 512 threads a row (one 16-byte vector each at H 3072), its
//     shared reads unrolled;
//   * the chain is short: the residual and the int8 rows are template
//     flags, the row's pointers formed once with 32-bit offsets inside it,
//     bf16 converted a pair per instruction. A first version with runtime
//     options and per-element conversions ran ~0.4 us a launch behind the
//     Triton kernel it replaced at [12, 3072] (PERF.md, PR 11's review
//     round);
//   * K4 without int8 rows has no reduction: blocks of 256 threads, one
//     16-byte vector of gate and of up per thread, so that all of every
//     row's bytes are in flight at once (48 blocks at [12, 8192]);
//   * the int8 rows cost an exact division per element (K6's rounding).
//     K4's need each row's max: a row is a cluster of up to 8 blocks that
//     trade their maxima through distributed shared memory (one cluster
//     barrier), so 8x the SMs share the divisions. K3 keeps one block a row
//     (its sum of squares, and so its output, stays the same bits with or
//     without int8 rows).
// - Prefill (4,096 to 8,192 rows): device-memory bytes (K3 [8192, 3072]
//   with its residual moves 201 MB, 0.060 ms at 3.35 TB/s; K4 [8192, 8192]
//   403 MB, 0.120 ms). A K3 row is a block of 384 threads at H 3072, so
//   5 rows (60 KB of loads) are in flight on each SM; a K4 thread takes
//   four vectors of gate and of up. Every byte is read once, written once.
// - Any width and row count: 16-byte vectors where every row start and
//   pointer is 16-byte aligned, else 8, 4 or 2; rows wider than the
//   registers hold (more than 4,096 vectors) take rows_loop_kernel, which
//   reads the row again (from L2) for its second and third passes.

#include "common.cuh"

namespace {

constexpr int OP_RMS = 0;
constexpr int OP_SWIGLU = 1;
constexpr int MAX_CLUSTER = 8;  // blocks per K4 int8-row cluster (portable size)
// Threads a row of rows_kernel takes, at most (more, down to a vector each,
// shorten each thread's chain; 256, 512 and 1024 measured on an H100, 512
// the best at 3072 and 8192 wide rows).
constexpr int REG_THREADS = 512;
constexpr int SWIGLU_THREADS = 256;  // a block of swiglu_kernel

// VB bytes held as 32-bit words (2 bytes: the low half of one word).
template <int VB>
struct Vec {
  static constexpr int N = VB >= 4 ? VB / 4 : 1;
  uint32_t w[N];

  __device__ __forceinline__ void load(const void* p) {
    if constexpr (VB == 32) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[0], b = reinterpret_cast<const uint4*>(p)[1];
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
    } else if constexpr (VB == 16) {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    } else if constexpr (VB == 8) {
      const uint2 a = *reinterpret_cast<const uint2*>(p);
      w[0] = a.x, w[1] = a.y;
    } else if constexpr (VB == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
  }
  __device__ __forceinline__ void store(void* p) const {
    if constexpr (VB == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VB == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (VB == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
    }
  }
};

// The E elements of a vector of T as floats, and E floats rounded to T
// into one: bf16 two to a 32-bit word, each pair rounded by one conversion
// (a vector of 2 bytes holds its one element in the low half).
template <typename T, int E>
__device__ __forceinline__ void unpack(const uint32_t* w, float (&f)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if constexpr (sizeof(T) == 4) f[e] = __uint_as_float(w[e]);
    else f[e] = __uint_as_float((e & 1) ? w[e >> 1] & 0xFFFF0000u : w[e >> 1] << 16);
  }
}
template <typename T, int E>
__device__ __forceinline__ void pack(uint32_t* w, const float (&f)[E]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < E; ++e) w[e] = __float_as_uint(f[e]);
  } else if constexpr (E == 1) {
    w[0] = __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  } else {
#pragma unroll
    for (int j = 0; j < E / 2; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = (uint32_t)__bfloat16_as_ushort(h.x) | ((uint32_t)__bfloat16_as_ushort(h.y) << 16);
    }
  }
}

// (g * sigmoid(g)) * u, the sigmoid from the SFU's exp2 and reciprocal
// (~2 ulp; the output is then rounded to the activation dtype): the
// IEEE-exact forms cost K4 0.3 us a call at decode width on an H100.
__device__ __forceinline__ float silu_mul(float g, float u) {
  return __fmul_rn(__fmul_rn(g, __fdividef(1.0f, 1.0f + __expf(-g))), u);
}

// E consecutive int8 values (E = 1, 2, 4 or 8) at p.
template <int E>
__device__ __forceinline__ void store_int8(int8_t* p, const int (&q)[E]) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const uint32_t b = (uint32_t)(q[e] & 0xFF) << (8 * (e & 3));
    if (e < 4) lo |= b; else hi |= b;
  }
  if constexpr (E == 8) *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  else if constexpr (E == 4) *reinterpret_cast<uint32_t*>(p) = lo;
  else if constexpr (E == 2) *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(lo);
  else *p = static_cast<int8_t>(lo);
}

// Sum (or max) over the blockDim.x threads of one row: a warp shuffle and,
// for rows of several warps (one row per block then, at most MAXW warps),
// one step through shared memory, its reads unrolled and issued together
// (the warps' values taken in order, so the sum's bits do not depend on it).
template <bool MAX, int MAXW>
__device__ __forceinline__ float row_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if (blockDim.x == 32) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = red[0];
#pragma unroll
  for (int i = 1; i < MAXW; ++i)
    if (i < nw) v = MAX ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

__device__ __forceinline__ int cluster_size() {
  int n;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Cluster barrier phases: every thread of the cluster arrives once, then
// waits for all the others' arrivals.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The max of v (the same in every thread of a block) over the cl blocks of
// the cluster: each block stores its v into its own slot of every block's
// `part` (distributed shared memory), and after one cluster barrier reads
// its local slots. The blocks arrived on a first barrier phase when they
// started (rows_kernel), so every peer is running before its memory is
// written; no block touches another's memory after the second, so none has
// to wait before it exits.
__device__ __forceinline__ float cluster_max(float v, float* part, int cl) {
  cluster_wait();
  if ((int)threadIdx.x < cl) {
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(cluster_addr(&part[cluster_rank()],
                                                                          threadIdx.x)),
                 "f"(v)
                 : "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" :::
                   "memory");
  v = part[0];
  for (int c = 1; c < cl; ++c) v = fmaxf(v, part[c]);
  return v;
}

// One row per group of blockDim.x threads (a multiple of 32): blockDim.y
// rows per block, more than one only where a row is one warp; or, for K4's
// int8 rows, one row per cluster of cl blocks (each takes 1 / cl of the
// row, so cl SMs share its exact divisions; a max is exact in any order, so
// the output is the same bits as without the int8 rows). Thread t of a
// row's block c takes vectors c * nb + t, c * nb + t + blockDim.x, ... (nb
// = ceil(vectors / cl) per block; VPT at most, in registers) of E = VB /
// sizeof(T) elements.
// OP_RMS: a = x, b = residual (or null), w = weight [H]; out, res (when b)
// [M, H]. OP_SWIGLU: a = gate, b = up (rows lda / ldb apart), out [M, H].
// xi / xs: the int8 rows [M, H] and fp32 scales [M] of out. RES: K3 has a
// residual (b, res); EMIT: xi / xs are written. K4 here always has both.
// At decode width the kernel's time is its instruction chain (PERF.md):
// the options are compile-time, the row's pointers formed once with 32-bit
// offsets inside the row, and bf16 converts a pair per instruction.
template <int OP, typename T, typename W, int VB, int VPT, bool CLUSTER, bool RES, bool EMIT>
__global__ void __launch_bounds__(REG_THREADS)
rows_kernel(const T* __restrict__ a, const T* __restrict__ b, const W* __restrict__ w,
            T* __restrict__ out, T* __restrict__ res, int8_t* __restrict__ xi,
            float* __restrict__ xs, int M, int H, long long lda, long long ldb, float eps) {
  constexpr int E = VB / sizeof(T);
  constexpr int WB = E * sizeof(W);
  constexpr int MAXW = REG_THREADS / 32;
  __shared__ float red_sum[MAXW], red_max[MAXW], part[MAX_CLUSTER];
  // Only the clustered instances read the cluster registers: a kernel that
  // does measured slower to dispatch on an H100, clusters or not.
  const int cl = CLUSTER ? cluster_size() : 1;
  const int t = threadIdx.x, nt = blockDim.x, nvec = H / E;
  const int nb = (nvec + cl - 1) / cl, first = CLUSTER ? cluster_rank() * nb : 0;
  const int mine = min(nvec, first + nb) - first;  // vectors of this block's part of the row
  const long long row = (long long)(blockIdx.x / cl) * blockDim.y + threadIdx.y;
  const long long at = (long long)first * E;  // that part's first element
  if (CLUSTER) cluster_arrive();  // waited on in cluster_max, long after
  Vec<WB> wv[VPT];
  if constexpr (OP == OP_RMS) {
    // The weight is no predecessor's output: its loads fly before the wait.
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (t + k * nt < mine) wv[k].load(w + at + (t + k * nt) * E);
  }
  pdl_wait();
  pdl_launch_dependents();
  if (row >= M) return;  // a whole warp of a one-warp row (cl is 1 then)
  const T* ap = a + row * lda + at;
  const T* bp = RES ? b + row * ldb + at : nullptr;
  T* op = out + row * H + at;
  Vec<VB> va[VPT], vb[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (t + k * nt < mine) {
      va[k].load(ap + (t + k * nt) * E);
      if constexpr (RES) vb[k].load(bp + (t + k * nt) * E);
    }
  }
  if constexpr (OP == OP_RMS) {
    T* rp = RES ? res + row * H + at : nullptr;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (t + k * nt >= mine) continue;
      float f[E];
      unpack<T>(va[k].w, f);
      if constexpr (RES) {
        float g[E];
        unpack<T>(vb[k].w, g);
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] += g[e];
        pack<T>(va[k].w, f);  // the rounded sum: the new residual, and what is normalised
        unpack<T>(va[k].w, f);
        va[k].store(rp + (t + k * nt) * E);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
    }
    ss = row_reduce<false, MAXW>(ss, red_sum);
    const float rstd = rsqrtf(ss / (float)H + eps);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (t + k * nt >= mine) continue;
      float f[E], g[E];
      unpack<T>(va[k].w, f);
      unpack<W>(wv[k].w, g);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], rstd), g[e]);
      pack<T>(va[k].w, f);
      va[k].store(op + (t + k * nt) * E);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (t + k * nt >= mine) continue;
      float f[E], g[E];
      unpack<T>(va[k].w, f);
      unpack<T>(vb[k].w, g);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = silu_mul(f[e], g[e]);
      pack<T>(va[k].w, f);
      va[k].store(op + (t + k * nt) * E);
    }
  }
  if constexpr (EMIT) {
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (t + k * nt >= mine) continue;
      float f[E];
      unpack<T>(va[k].w, f);
#pragma unroll
      for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
    amax = row_reduce<true, MAXW>(amax, red_max);
    const float s = quant_scale(CLUSTER ? cluster_max(amax, part, cl) : amax);
    if (t == 0 && first == 0) xs[row] = s;
    int8_t* qp = xi + row * H + at;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (t + k * nt >= mine) continue;
      float f[E];
      unpack<T>(va[k].w, f);
      int q[E];
#pragma unroll
      for (int e = 0; e < E; ++e) q[e] = quant_int8(f[e], s);
      store_int8<E>(qp + (t + k * nt) * E, q);
    }
  }
}

// rows_kernel's function for rows wider than its registers hold: one row
// per block of 1024 threads, each pass over the row a loop. The second
// (and third) pass reread what this thread itself wrote in the first
// (second), from L2.
template <int OP, typename T, typename W, int VB>
__global__ void __launch_bounds__(1024)
rows_loop_kernel(const T* __restrict__ a, const T* __restrict__ b, const W* __restrict__ w,
                 T* __restrict__ out, T* __restrict__ res, int8_t* __restrict__ xi,
                 float* __restrict__ xs, int M, int H, long long lda, long long ldb, float eps) {
  constexpr int E = VB / sizeof(T);
  constexpr int WB = E * sizeof(W);
  __shared__ float red_sum[32], red_max[32];
  const int t = threadIdx.x, nt = blockDim.x, nvec = H / E;
  const long long row = blockIdx.x;
  pdl_wait();
  pdl_launch_dependents();
  const T* ap = a + row * lda;
  const T* bp = b ? b + row * ldb : nullptr;
  T* op = out + row * H;
  float amax = 0.f;
  if constexpr (OP == OP_RMS) {
    T* rp = b ? res + row * H : nullptr;
    const T* src = b ? rp : ap;  // the rounded sum, or x
    float ss = 0.f;
    for (int i = t; i < nvec; i += nt) {
      Vec<VB> va;
      va.load(ap + i * E);
      float f[E];
      unpack<T>(va.w, f);
      if (b) {
        Vec<VB> vb;
        vb.load(bp + i * E);
        float g[E];
        unpack<T>(vb.w, g);
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] += g[e];
        pack<T>(va.w, f);
        unpack<T>(va.w, f);
        va.store(rp + i * E);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
    }
    ss = row_reduce<false, 32>(ss, red_sum);
    const float rstd = rsqrtf(ss / (float)H + eps);
    for (int i = t; i < nvec; i += nt) {
      Vec<VB> va;
      Vec<WB> wv;
      va.load(src + i * E);
      wv.load(w + i * E);
      float f[E], g[E];
      unpack<T>(va.w, f);
      unpack<W>(wv.w, g);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], rstd), g[e]);
      pack<T>(va.w, f);
      va.store(op + i * E);
      if (xi) {
        unpack<T>(va.w, f);
#pragma unroll
        for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
    }
  } else {
    for (int i = t; i < nvec; i += nt) {
      Vec<VB> va, vb;
      va.load(ap + i * E);
      vb.load(bp + i * E);
      float f[E], g[E];
      unpack<T>(va.w, f);
      unpack<T>(vb.w, g);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = silu_mul(f[e], g[e]);
      pack<T>(va.w, f);
      va.store(op + i * E);
      if (xi) {
        unpack<T>(va.w, f);
#pragma unroll
        for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
    }
  }
  if (!xi) return;
  const float s = quant_scale(row_reduce<true, 32>(amax, red_max));
  if (t == 0) xs[row] = s;
  for (int i = t; i < nvec; i += nt) {
    Vec<VB> va;
    va.load(op + i * E);
    float f[E];
    unpack<T>(va.w, f);
    int q[E];
#pragma unroll
    for (int e = 0; e < E; ++e) q[e] = quant_int8(f[e], s);
    store_int8<E>(xi + row * H + i * E, q);
  }
}

// K4 without int8 rows: elementwise. Grid (rows, column chunks) of
// SWIGLU_THREADS threads; thread t of chunk c takes vectors (c * VPT + k) *
// SWIGLU_THREADS + t.
template <typename T, int VB, int VPT>
__global__ void __launch_bounds__(SWIGLU_THREADS)
swiglu_kernel(const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ out, int I,
              long long ldg, long long ldu) {
  constexpr int E = VB / sizeof(T);
  const int nvec = I / E;
  const long long row = blockIdx.x;
  pdl_wait();
  pdl_launch_dependents();
  const T* gp = g + row * ldg;
  const T* up = u + row * ldu;
  T* op = out + row * I;
  Vec<VB> vg[VPT], vu[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = (blockIdx.y * VPT + k) * SWIGLU_THREADS + threadIdx.x;
    if (i < nvec) {
      vg[k].load(gp + i * E);
      vu[k].load(up + i * E);
    }
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = (blockIdx.y * VPT + k) * SWIGLU_THREADS + threadIdx.x;
    if (i >= nvec) continue;
    float f[E], h[E];
    unpack<T>(vg[k].w, f);
    unpack<T>(vu[k].w, h);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = silu_mul(f[e], h[e]);
    pack<T>(vg[k].w, f);
    vg[k].store(op + i * E);
  }
}

// The floor of one launch, timed beside K3 / K4 (chip_smoke.py phase 3):
// the PDL handshake every kernel here makes and, with src, one 16-byte
// vector per thread copied from src to dst after it (the dependent load and
// store every K3 / K4 makes).
__global__ void empty_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst) {
  pdl_wait();
  pdl_launch_dependents();
  if (src) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    dst[i] = src[i];
  }
}

// ---------------------------------------------------------------------------
// Launch plans

struct Args {
  const void* a;
  const void* b;
  const void* w;
  void* out;
  void* res;
  void* xi;
  void* xs;
  int M, H;
  long long lda, ldb;
  float eps;
};

// vb: bytes per vector; vpt: vectors per thread (0: rows_loop_kernel; for
// swiglu_kernel 1 or 4); block, grid, cluster: the launch.
struct Plan {
  int vb, vpt;
  dim3 block, grid;
  int cluster;
};

// The widest vector (16, 8, 4 or 2 bytes, at least one element) that every
// address and row stride in `bits` (their OR) is a multiple of; `wbits`,
// the weight's address, must be a multiple of the weight's vector (E
// elements of wsize bytes) or of 16 bytes.
int vector_bytes(unsigned long long bits, unsigned long long wbits, int esize, int wsize) {
  int vb = 16;
  while (vb > esize &&
         (bits % vb || wbits % (unsigned long long)min(vb / esize * wsize, 16)))
    vb >>= 1;
  return vb;
}


constexpr int LOOP_THREADS = 1024;
constexpr int CLUSTER_VECTORS = 128;  // vectors per block of a K4 int8-row cluster

// rows_kernel's launch: one row per block (several one-warp rows per block
// for narrow rows), or, with `clustered` (K4's int8 rows, for K6: 256 rows
// at most), one row per cluster of up to MAX_CLUSTER blocks of ~128
// vectors. K3 keeps its layout with int8 rows too: its sum of squares, and
// so its output, is then the same bits either way.
Plan plan_rows(int M, int H, int vb, int esize, bool clustered) {
  const int nvec = H / (vb / esize);
  const int cl =
      clustered ? min(MAX_CLUSTER, max(1, (nvec + CLUSTER_VECTORS - 1) / CLUSTER_VECTORS)) : 1;
  const int nb = (nvec + cl - 1) / cl;
  int vpt = 1;
  while (vpt < 8 && (nb + vpt - 1) / vpt > REG_THREADS) vpt *= 2;
  const int threads = ((nb + vpt - 1) / vpt + 31) / 32 * 32;
  if (threads > REG_THREADS) return {vb, 0, dim3(LOOP_THREADS), dim3(M), 1};
  if (cl > 1) return {vb, vpt, dim3(threads), dim3(M * cl), cl};
  const int rpb = threads == 32 ? 8 : 1;
  return {vb, vpt, dim3(threads, rpb), dim3((M + rpb - 1) / rpb), 1};
}

// K4 takes four vectors per thread where the call is large enough for
// every SM to stream (about a million 16-byte vectors of each input), one
// otherwise (decode: more blocks, every row's bytes in flight at once).
Plan plan_swiglu(int M, int I, int vb, int esize) {
  const long long nvec = I / (vb / esize);
  const int vpt = (long long)M * nvec >= (1LL << 20) ? 4 : 1;
  const long long per_block = (long long)SWIGLU_THREADS * vpt;
  return {vb, vpt, dim3(SWIGLU_THREADS), dim3(M, (unsigned)((nvec + per_block - 1) / per_block)), 1};
}

template <int OP, typename T, typename W, int VB, bool CLUSTER, bool RES, bool EMIT>
cudaError_t launch_rows_flags(const Args& a, const Plan& p, cudaStream_t st) {
  auto run = [&](auto kernel) {
    return launch_kernel(kernel, {p.grid, p.block, 0, st, false, p.cluster},
                         static_cast<const T*>(a.a), static_cast<const T*>(a.b),
                         static_cast<const W*>(a.w), static_cast<T*>(a.out),
                         static_cast<T*>(a.res), static_cast<int8_t*>(a.xi),
                         static_cast<float*>(a.xs), a.M, a.H, a.lda, a.ldb, a.eps);
  };
  switch (p.vpt) {
    case 1: return run(rows_kernel<OP, T, W, VB, 1, CLUSTER, RES, EMIT>);
    case 2: return run(rows_kernel<OP, T, W, VB, 2, CLUSTER, RES, EMIT>);
    case 4: return run(rows_kernel<OP, T, W, VB, 4, CLUSTER, RES, EMIT>);
    default: return run(rows_kernel<OP, T, W, VB, 8, CLUSTER, RES, EMIT>);
  }
}

template <int OP, typename T, typename W, int VB, bool CLUSTER>
cudaError_t launch_rows_cl(const Args& a, const Plan& p, cudaStream_t st) {
  if constexpr (OP == OP_SWIGLU) {
    return launch_rows_flags<OP, T, W, VB, CLUSTER, true, true>(a, p, st);
  } else {
    if (a.b)
      return a.xi ? launch_rows_flags<OP, T, W, VB, CLUSTER, true, true>(a, p, st)
                  : launch_rows_flags<OP, T, W, VB, CLUSTER, true, false>(a, p, st);
    return a.xi ? launch_rows_flags<OP, T, W, VB, CLUSTER, false, true>(a, p, st)
                : launch_rows_flags<OP, T, W, VB, CLUSTER, false, false>(a, p, st);
  }
}

template <int OP, typename T, typename W, int VB>
cudaError_t launch_rows_vb(const Args& a, const Plan& p, cudaStream_t st) {
  if (p.vpt == 0) {
    return launch_kernel(rows_loop_kernel<OP, T, W, VB>, {p.grid, p.block, 0, st, false},
                         static_cast<const T*>(a.a), static_cast<const T*>(a.b),
                         static_cast<const W*>(a.w), static_cast<T*>(a.out),
                         static_cast<T*>(a.res), static_cast<int8_t*>(a.xi),
                         static_cast<float*>(a.xs), a.M, a.H, a.lda, a.ldb, a.eps);
  }
  if constexpr (OP == OP_SWIGLU)
    if (p.cluster > 1) return launch_rows_cl<OP, T, W, VB, true>(a, p, st);
  return launch_rows_cl<OP, T, W, VB, false>(a, p, st);
}

template <int OP, typename T, typename W>
cudaError_t launch_rows(const Args& a, const Plan& p, cudaStream_t st) {
  switch (p.vb) {
    case 16: return launch_rows_vb<OP, T, W, 16>(a, p, st);
    case 8: return launch_rows_vb<OP, T, W, 8>(a, p, st);
    case 4: return launch_rows_vb<OP, T, W, 4>(a, p, st);
    default:
      if constexpr (sizeof(T) == 2) return launch_rows_vb<OP, T, W, 2>(a, p, st);
      return cudaErrorInvalidValue;
  }
}

template <typename T, int VB>
cudaError_t launch_swiglu_vb(const Args& a, const Plan& p, cudaStream_t st) {
  auto run = [&](auto kernel) {
    return launch_kernel(kernel, {p.grid, p.block, 0, st, false}, static_cast<const T*>(a.a),
                         static_cast<const T*>(a.b), static_cast<T*>(a.out), a.H, a.lda, a.ldb);
  };
  return p.vpt == 4 ? run(swiglu_kernel<T, VB, 4>) : run(swiglu_kernel<T, VB, 1>);
}

template <typename T>
cudaError_t launch_swiglu(const Args& a, const Plan& p, cudaStream_t st) {
  switch (p.vb) {
    case 16: return launch_swiglu_vb<T, 16>(a, p, st);
    case 8: return launch_swiglu_vb<T, 8>(a, p, st);
    case 4: return launch_swiglu_vb<T, 4>(a, p, st);
    default:
      if constexpr (sizeof(T) == 2) return launch_swiglu_vb<T, 2>(a, p, st);
      return cudaErrorInvalidValue;
  }
}

unsigned long long addr(const void* p) { return reinterpret_cast<unsigned long long>(p); }

// The plans of K3 (op 0) and K4 (op 1) from the shapes, the addresses and
// whether int8 rows are written.
Plan plan_rms(const Args& a, int fp32, int w_fp32) {
  const int es = fp32 ? 4 : 2;
  const unsigned long long bits = addr(a.a) | addr(a.b) | addr(a.out) | addr(a.res) |
                                  (unsigned long long)a.H * es;
  return plan_rows(a.M, a.H, vector_bytes(bits, addr(a.w), es, w_fp32 ? 4 : es), es, false);
}

Plan plan_k4(const Args& a, int fp32) {
  const int es = fp32 ? 4 : 2;
  const unsigned long long bits = addr(a.a) | addr(a.b) | addr(a.out) |
                                  (unsigned long long)a.H * es |
                                  (unsigned long long)a.lda * es | (unsigned long long)a.ldb * es;
  const int vb = vector_bytes(bits, 0, es, es);
  return a.xi ? plan_rows(a.M, a.H, vb, es, true) : plan_swiglu(a.M, a.H, vb, es);
}

int finish(cudaError_t e) { return (int)(e != cudaSuccess ? e : cudaGetLastError()); }

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3: out = rms_norm(x + r) * w, res = x + r rounded (r null: rms_norm(x),
// no res). x, r, out, res [M, H] contiguous, bf16 (fp32 when fp32); w [H]
// of x's dtype (fp32 when w_fp32). xi [M, H] int8 and xs [M] fp32 (both
// or neither): the int8 rows of out, as qmm_quantize_rows would give them.
extern "C" int norms_rms(const void* x, const void* r, const void* w, void* out, void* res,
                         void* xi, void* xs, int M, int H, float eps, int fp32, int w_fp32,
                         void* stream) {
  if (M < 1 || H < 1 || !x || !w || !out || (!r != !res) || (!xi != !xs) || (fp32 && !w_fp32))
    return (int)cudaErrorInvalidValue;
  const Args a{x, r, w, out, res, xi, xs, M, H, H, H, eps};
  const Plan p = plan_rms(a, fp32, w_fp32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp32) return finish(launch_rows<OP_RMS, float, float>(a, p, st));
  if (w_fp32) return finish(launch_rows<OP_RMS, __nv_bfloat16, float>(a, p, st));
  return finish(launch_rows<OP_RMS, __nv_bfloat16, __nv_bfloat16>(a, p, st));
}

// K4: out = silu(g) * u. g, u [M, I] rows ldg / ldu elements apart (unit
// stride within a row), out [M, I] contiguous, bf16 (fp32 when fp32); xi /
// xs as for norms_rms.
extern "C" int norms_swiglu(const void* g, const void* u, void* out, void* xi, void* xs, int M,
                            int I, long long ldg, long long ldu, int fp32, void* stream) {
  if (M < 1 || I < 1 || !g || !u || !out || (!xi != !xs) || ldg < I || ldu < I)
    return (int)cudaErrorInvalidValue;
  const Args a{g, u, nullptr, out, nullptr, xi, xs, M, I, ldg, ldu, 0.f};
  const Plan p = plan_k4(a, fp32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xi)
    return finish(fp32 ? launch_rows<OP_SWIGLU, float, float>(a, p, st)
                       : launch_rows<OP_SWIGLU, __nv_bfloat16, __nv_bfloat16>(a, p, st));
  return finish(fp32 ? launch_swiglu<float>(a, p, st) : launch_swiglu<__nv_bfloat16>(a, p, st));
}

// The launch K3 (op 0) or K4 (op 1) makes at this shape, for the same
// arguments as above: shape = {vector bytes, vectors per thread (0: the
// loop kernel), block x, block y, grid x, grid y, cluster}.
extern "C" int norms_launch_shape(int op, const void* a, const void* b, const void* w,
                                  const void* out, int emit, int M, int H, long long lda,
                                  long long ldb, int fp32, int w_fp32, int* shape) {
  Args args{a, b, w, const_cast<void*>(out), op == 0 ? const_cast<void*>(b) : nullptr,
            emit ? shape : nullptr, emit ? shape : nullptr, M, H, lda, ldb, 0.f};
  const Plan p = op == 0 ? plan_rms(args, fp32, w_fp32) : plan_k4(args, fp32);
  const int v[7] = {p.vb,           p.vpt,          (int)p.block.x, (int)p.block.y,
                    (int)p.grid.x, (int)p.grid.y, p.cluster};
  for (int i = 0; i < 7; ++i) shape[i] = v[i];
  return 0;
}

// The empty kernel, `blocks` x `threads`, as a programmatic dependent when
// pdl; src / dst (or null): 16 bytes per thread to copy.
extern "C" int norms_empty(int blocks, int threads, int pdl, const void* src, void* dst,
                           void* stream) {
  return finish(launch_kernel(empty_kernel,
                              {dim3(blocks), dim3(threads), 0, static_cast<cudaStream_t>(stream),
                               pdl != 0},
                              static_cast<const uint4*>(src), static_cast<uint4*>(dst)));
}
