// W4A8 and W8A8 weight matmuls for Hopper (sm_90a), one kernel template.
//
// Replaces the TPU kernels of lite_llama_tpu/ops/qmatmul.py:
// - K6, quantized_matmul_packed -> _qmm_kernel (PACKED): int8 activations
//   [M, C] against packed int4 weight bytes [Lf, C, Wn] (byte = 16*hi +
//   (lo + 8), paired fp32 scales [Lf, nG, Wn]). Per scale group the kernel
//   runs the TPU kernel's integer identity on the RAW bytes:
//       g0 = x . b,  g1 = x . (b & 0x0F)          (exact int32 dots)
//       acc_e += (g1 - 8 * sum(x_g)) * s          (even / lo columns)
//       acc_o += (g0 - g1) * (s * 0.0625)         (odd / hi columns)
//   and multiplies by the row's activation scale on the way out.
// - K7, quantized_matmul_int8 -> _qmm8_kernel (!PACKED): int8 weights
//   [Lf, C, Wn]; acc += (x . w) * s per group.
// Per-channel weights (nG = 1) fold at every F-row contraction block, the
// TPU kernel's C block, so the fp32 sums are taken in its order; the fold
// uses __fmul_rn / __fadd_rn (no fused multiply-add) and matches the plain
// version (ops/qmatmul.py) bit for bit.
//
// What bounds it: device-memory bytes. At decode (M = 12..64 rows) every
// weight byte is read once for 2*M integer operations, far below the ~590
// int8 operations per byte at which the tensor cores would be the limit.
//
// Design:
// - Grid (Wn / 32 byte columns, M / (16*MT) row tiles); 4 warps, warp w owns
//   byte columns [8w, 8w + 8) of the block. The layer index selects the
//   layer's slice of the stacked weight by a pointer offset: no copy.
// - The weight strip streams through shared memory in 256-row chunks, with
//   the block's activation rows for the same 256 columns and the scales of
//   the folds that end in the chunk: the next chunk's loads are issued into
//   registers before the current chunk is computed, so no global load sits
//   in the chain of tensor-core steps, and a block keeps 8 KB of weights in
//   flight.
// - int8 tensor cores via mma.sync.m16n8k32.s32.s8.s8.s32 on the raw bytes
//   and, for int4, on b & 0x0F0F0F0F (one 32-bit AND per four bytes).
//   A fragments load from shared memory as 32-bit words; B fragments gather
//   four k-rows of one column (row stride 36 bytes: no bank conflicts).
// - sum(x_g) comes from the A fragments (dp4a with ones) reduced over the
//   fragment quad at each fold: the same integers the quantizer produced.
// - The activations are quantized by a small kernel of their own
//   (quantize_rows_kernel, a block per row), the plain version's arithmetic:
//   one launch where PyTorch's eager ops take nine.
// - The epilogue writes straight into the final columns: classic packing
//   interleaved (2j, 2j+1), riffle packing [evens | odds], pad columns past
//   the logical width skipped, bf16 or fp32.
// Simple first: one block per output strip with a loop over all of C (no
// split over C), no TMA, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 32;        // byte columns per block (8 per warp)
constexpr int KC = 256;       // contraction rows per shared-memory chunk
constexpr int SBS = BN + 4;   // shared-memory row stride in bytes
constexpr int XS = KC + 16;   // shared-memory row stride of the activation chunk
constexpr int STEPS = KC / 32;  // mma k-steps per chunk
constexpr int LOADS = KC * BN / 16 / THREADS;  // 16-byte weight loads per thread per chunk
constexpr int ROWS_PER_LOAD = THREADS * 16 / BN;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four k-rows of one column (stride SBS) as one register, row k in byte k.
__device__ __forceinline__ uint32_t col4(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[SBS] << 8) | ((uint32_t)p[2 * SBS] << 16) |
         ((uint32_t)p[3 * SBS] << 24);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void st16(uint8_t* p, uint4 v) {  // 4-byte aligned p
  uint32_t* d = reinterpret_cast<uint32_t*>(p);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int MT, bool PACKED, typename OutT>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const int8_t* __restrict__ x,      // [M, C] int8 activations
           const float* __restrict__ xs,      // [M] activation row scales
           const int8_t* __restrict__ w,      // [C, Wn] this layer's weight bytes
           const float* __restrict__ scale,   // [nG, Wn] this layer's scales
           OutT* __restrict__ out,            // [M, ldo]
           int M, int C, int Wn, int nG, int F, int width, int ldo, int riffle) {
  constexpr int XROWS = 16 * MT;
  constexpr int XLOADS = XROWS * KC / 16 / THREADS;  // 16-byte activation loads per thread
  __shared__ __align__(16) uint8_t sB[KC * SBS];
  __shared__ __align__(16) int8_t sX[XROWS * XS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // fragment column quad
  const int n_blk = blockIdx.x * BN;
  const int m_blk = blockIdx.y * XROWS;
  const int gsz = C / nG;  // rows of one scale group
  const int lrow = tid / (BN / 16);
  const int lcol = (tid % (BN / 16)) * 16;
  const int ncol = warp * 8 + gq;              // shared-memory column of this thread's B fragments
  const int jcol = n_blk + warp * 8 + tq * 2;  // first of this thread's two C columns

  // The next chunk in registers: weight strip, activation rows, and the
  // scales of the folds that end at each of its k-steps.
  uint4 wst[LOADS], xst[XLOADS];
  float2 snext[STEPS], scur[STEPS];
  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int r = c0 + lrow + ROWS_PER_LOAD * i;
      wst[i] = r < C ? *reinterpret_cast<const uint4*>(w + (long long)r * Wn + n_blk + lcol)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < XLOADS; ++i) {
      const int idx = tid + THREADS * i;
      const int r = m_blk + idx / (KC / 16);
      const int c = c0 + (idx % (KC / 16)) * 16;
      xst[i] = r < M && c < C ? *reinterpret_cast<const uint4*>(x + (long long)r * C + c)
                              : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      const int end = c0 + 32 * (ks + 1);
      snext[ks] = end <= C && end % F == 0
                      ? *reinterpret_cast<const float2*>(scale + (long long)((end - F) / gsz) * Wn +
                                                         jcol)
                      : make_float2(0.f, 0.f);
    }
  };

  int g0[MT][4], g1[MT][4], xsum[MT][2];
  float acc_e[MT][4], acc_o[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    xsum[mt][0] = xsum[mt][1] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      g0[mt][i] = g1[mt][i] = 0;
      acc_e[mt][i] = acc_o[mt][i] = 0.f;
    }
  }

  load_chunk(0);
  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < LOADS; ++i) st16(&sB[(lrow + ROWS_PER_LOAD * i) * SBS + lcol], wst[i]);
#pragma unroll
    for (int i = 0; i < XLOADS; ++i) {
      const int idx = tid + THREADS * i;
      *reinterpret_cast<uint4*>(&sX[(idx / (KC / 16)) * XS + (idx % (KC / 16)) * 16]) = xst[i];
    }
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) scur[ks] = snext[ks];
    __syncthreads();
    if (c0 + KC < C) load_chunk(c0 + KC);  // in flight during the compute below
    const int rows = min(KC, C - c0);
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      const int k0 = ks * 32;
      if (k0 >= rows) break;  // uniform over the block
      const uint8_t* bp = &sB[(k0 + tq * 4) * SBS + ncol];
      const uint32_t b0 = col4(bp), b1 = col4(bp + 16 * SBS);
      const uint32_t l0 = b0 & 0x0F0F0F0Fu, l1 = b1 & 0x0F0F0F0Fu;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* x0 = &sX[(mt * 16 + gq) * XS + k0 + tq * 4];
        const int8_t* x1 = x0 + 8 * XS;
        const uint32_t a[4] = {ld32(x0), ld32(x1), ld32(x0 + 16), ld32(x1 + 16)};
        mma_s8(g0[mt], a, b0, b1);
        if (PACKED) {
          mma_s8(g1[mt], a, l0, l1);
          xsum[mt][0] = __dp4a((int)a[0], 0x01010101, xsum[mt][0]);
          xsum[mt][0] = __dp4a((int)a[2], 0x01010101, xsum[mt][0]);
          xsum[mt][1] = __dp4a((int)a[1], 0x01010101, xsum[mt][1]);
          xsum[mt][1] = __dp4a((int)a[3], 0x01010101, xsum[mt][1]);
        }
      }
      if ((c0 + k0 + 32) % F == 0) {  // fold the int32 partials of the last F rows
        const float2 s = scur[ks];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          int xr[2] = {xsum[mt][0], xsum[mt][1]};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            xr[h] += __shfl_xor_sync(0xffffffffu, xr[h], 1);
            xr[h] += __shfl_xor_sync(0xffffffffu, xr[h], 2);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float sc = (i & 1) ? s.y : s.x;
            if (PACKED) {
              const int corr = g1[mt][i] - 8 * xr[i >> 1];
              acc_e[mt][i] = __fadd_rn(acc_e[mt][i], __fmul_rn((float)corr, sc));
              acc_o[mt][i] = __fadd_rn(acc_o[mt][i],
                                       __fmul_rn((float)(g0[mt][i] - g1[mt][i]), sc * 0.0625f));
            } else {
              acc_e[mt][i] = __fadd_rn(acc_e[mt][i], __fmul_rn((float)g0[mt][i], sc));
            }
            g0[mt][i] = g1[mt][i] = 0;
          }
          xsum[mt][0] = xsum[mt][1] = 0;
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m_blk + mt * 16 + gq + (i >> 1) * 8;
      if (r >= M) continue;
      const float xr = xs[r];
      const int j = jcol + (i & 1);
      OutT* orow = out + (long long)r * ldo;
      if (PACKED) {
        const int ce = riffle ? j : 2 * j;
        const int co = riffle ? Wn + j : 2 * j + 1;
        if (ce < width) store(orow + ce, __fmul_rn(acc_e[mt][i], xr));
        if (co < width) store(orow + co, __fmul_rn(acc_o[mt][i], xr));
      } else if (j < width) {
        store(orow + j, __fmul_rn(acc_e[mt][i], xr));
      }
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Per-row symmetric int8 activations, as ops/qmatmul.py _quantize_rows:
// xs = max(max|x|, 1e-30) * fp32(1/127) (XLA's product with the reciprocal
// of a constant divisor), xi = clamp(round-half-even(x / xs), -127, 127).
template <typename InT>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const InT* __restrict__ x, int8_t* __restrict__ xi, float* __restrict__ xs,
                     int C) {
  __shared__ float red[8];
  const InT* xr = x + (long long)blockIdx.x * C;
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int c = threadIdx.x; c < C; c += 256) amax = fmaxf(amax, fabsf(to_float(xr[c])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < 8; ++w) amax = fmaxf(amax, red[w]);
  const float s = __fmul_rn(fmaxf(amax, 1e-30f), 1.0f / 127.0f);
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
  int8_t* qr = xi + (long long)blockIdx.x * C;
  for (int c = threadIdx.x; c < C; c += 256)
    qr[c] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(to_float(xr[c]), s)), -127.f), 127.f);
}

template <bool PACKED, typename OutT>
int launch_t(const void* x, const void* xs, const void* w, const void* scale, void* out, int M,
             int C, int Wn, int nG, int F, int layer, int width, int ldo, int riffle,
             cudaStream_t st) {
  const int8_t* wl = static_cast<const int8_t*>(w) + (long long)layer * C * Wn;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * nG * Wn;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* xsp = static_cast<const float*>(xs);
  auto* op = static_cast<OutT*>(out);
  const int MT = min(4, (M + 15) / 16);
  const dim3 grid(Wn / BN, (M + 16 * MT - 1) / (16 * MT));
#define QMM_LAUNCH(T)                                                                       \
  qmm_kernel<T, PACKED, OutT><<<grid, THREADS, 0, st>>>(xp, xsp, wl, sl, op, M, C, Wn, nG, F, \
                                                        width, ldo, riffle)
  switch (MT) {
    case 1: QMM_LAUNCH(1); break;
    case 2: QMM_LAUNCH(2); break;
    case 3: QMM_LAUNCH(3); break;
    default: QMM_LAUNCH(4); break;
  }
#undef QMM_LAUNCH
  return (int)cudaGetLastError();
}

template <bool PACKED>
int launch(const void* x, const void* xs, const void* w, const void* scale, void* out,
           int out_fp32, int M, int C, int Wn, int nG, int F, int layer, int width, int ldo,
           int riffle, void* stream) {
  if (M < 1 || M > 256 || C % 32 || nG < 1 || C % nG || (C / nG) % 32 || F % 32 || F < 32 ||
      C % F || Wn % BN || width < 1 || ldo < width)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_fp32)
    return launch_t<PACKED, float>(x, xs, w, scale, out, M, C, Wn, nG, F, layer, width, ldo,
                                   riffle, st);
  return launch_t<PACKED, __nv_bfloat16>(x, xs, w, scale, out, M, C, Wn, nG, F, layer, width,
                                         ldo, riffle, st);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The activation quantizer of K6 and K7: x [M, C] bf16 (or fp32 when
// x_fp32) -> xi [M, C] int8, xs [M] fp32.
extern "C" int qmm_quantize_rows(const void* x, int x_fp32, void* xi, void* xs, int M, int C,
                                 void* stream) {
  if (M < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<int8_t*>(xi);
  auto* sp = static_cast<float*>(xs);
  if (x_fp32)
    quantize_rows_kernel<float><<<M, 256, 0, st>>>(static_cast<const float*>(x), qp, sp, C);
  else
    quantize_rows_kernel<__nv_bfloat16><<<M, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qp, sp, C);
  return (int)cudaGetLastError();
}

// K6: packed int4 weights. riffle: write [evens | odds] instead of
// interleaving. Columns >= width (lane-alignment padding) are not written.
extern "C" int qmm_w4a8(const void* x, const void* xs, const void* w, const void* scale,
                        void* out, int out_fp32, int M, int C, int Wn, int nG, int F, int layer,
                        int width, int ldo, int riffle, void* stream) {
  return launch<true>(x, xs, w, scale, out, out_fp32, M, C, Wn, nG, F, layer, width, ldo,
                      riffle, stream);
}

// K7: int8 weights.
extern "C" int qmm_w8a8(const void* x, const void* xs, const void* w, const void* scale,
                        void* out, int out_fp32, int M, int C, int Wn, int nG, int F, int layer,
                        int width, int ldo, int riffle, void* stream) {
  return launch<false>(x, xs, w, scale, out, out_fp32, M, C, Wn, nG, F, layer, width, ldo,
                       riffle, stream);
}
