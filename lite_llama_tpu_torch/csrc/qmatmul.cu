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
// So the levers are blocks on the card and weight bytes in flight.
//
// Design:
// - Grid (Wn / 32 byte columns, M / (16*MT) row tiles, S splits of C); 4
//   warps, warp w owns byte columns [8w, 8w + 8) of the block. The layer
//   index selects the layer's slice of the stacked weight by a pointer
//   offset: no copy.
// - Split over C with an in-order fold. Split s owns the contraction rows
//   [sp.row[s], sp.row[s+1]), whole fold spans on 32-row steps
//   (ops/qmatmul.py plan_splits picks S and the rows; S > 1 only where the
//   column and row tiles alone leave SMs idle). Split 0 folds into its fp32
//   accumulators as an unsplit block does; split s > 0 keeps each span's
//   two fp32 terms in shared memory, waits until its tile's counter reads s
//   (ld.acquire.gpu), continues the running sums split s-1 left in the
//   workspace (L2), in order, and publishes them with a release and counter
//   s + 1. The last split writes the output and sets the counter back to 0,
//   so the workspace is ready for the next launch without a clear (a CUDA
//   graph can replay the launch). Every float is rounded as the plain
//   version rounds it; no value is added atomically. The split is the
//   slowest grid dimension and the launcher refuses a split grid that is
//   not co-resident, so a waiting block never holds an SM its predecessor
//   needs; a wait past ~10 s traps rather than hang the card (the one way
//   left to starve a split: two split grids on two streams at once, each
//   holding the SMs the other's earlier splits need).
// - The weight strip streams through a ring of STAGES shared-memory stages,
//   each a 256-row chunk (8 KB of weights) with the block's activation rows
//   for the same 256 columns and the scales of the folds that end in the
//   chunk, filled by cp.async.cg 16-byte copies: STAGES - 1 chunks are in
//   flight while one is computed, and one block barrier per chunk.
// - int8 tensor cores via mma.sync.m16n8k32.s32.s8.s8.s32 on the raw bytes
//   and, for int4, on b & 0x0F0F0F0F (one 32-bit AND per four bytes).
//   A fragments load from shared memory as 32-bit words; B fragments gather
//   four k-rows of one column. A weight row is 32 bytes (a cp.async
//   destination must be 16-byte aligned, which rules out a conflict-free
//   36-byte stride); its two 16-byte halves swap places on every other group
//   of four rows (XOR swizzle), which leaves a 2-way bank conflict in the
//   gathers where an unswizzled 32-byte stride has a 4-way one. Each weight
//   byte is read from shared memory once, so the conflict costs little.
// - Fold spans that are not a multiple of 32 rows (KSTEP 16 or 8): each
//   32-row step runs as two m16n8k16 steps ({a0, a1} with b0, then {a2, a3}
//   with b1) with a fold check after each; for an odd multiple of 8 rows
//   each k16 step runs twice, the A words of lanes tq >= 2 (k 8-15) zeroed
//   in the first pass and those of lanes tq < 2 (k 0-7) in the second, with
//   a fold check after each.
// - sum(x_g) comes from the A fragments (dp4a with ones) reduced over the
//   fragment quad at each fold: the same integers the quantizer produced.
// - The activations are quantized by a small kernel of their own
//   (quantize_rows_kernel, a block per row), the plain version's arithmetic:
//   one launch where PyTorch's eager ops take nine. A split matmul grid is
//   launched as its programmatic dependent: its blocks start while the
//   quantizer runs, put their first weight chunks in flight, and wait
//   (griddepcontrol.wait) only before they read the quantized rows.
// - A fold check compares the row reached with the next span's end (no
//   integer division in the k-step loop).
// - The epilogue writes straight into the final columns: classic packing
//   interleaved (2j, 2j+1), riffle packing [evens | odds], pad columns past
//   the logical width skipped, bf16 or fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 32;        // byte columns per block (8 per warp)
constexpr int KC = 256;       // contraction rows per shared-memory chunk
constexpr int XS = KC + 16;   // shared-memory row stride of the activation chunk
constexpr int STEPS = KC / 32;  // 32-row k-steps per chunk
constexpr int LOADS = KC * BN / 16 / THREADS;  // 16-byte weight copies per thread per chunk
constexpr int STAGES = 3;     // ring stages (ops/qmatmul.py _STAGES)
constexpr int MAX_SPLITS = 16;  // ops/qmatmul.py _MAX_SPLITS

// The contraction rows of each split: split s owns [row[s], row[s+1]).
struct Splits {
  int row[MAX_SPLITS + 1];
};

// One ring stage: the weight chunk, the activation chunk and the chunk's
// fold scales.
__host__ __device__ constexpr int stage_bytes(int MT, int KSTEP) {
  return KC * BN + 16 * MT * XS + (KC / KSTEP) * BN * 4;
}

// Dynamic shared memory of one block (ops/qmatmul.py _smem_bytes): the ring
// and the held fp32 terms of nspan fold spans (splits s > 0).
constexpr int smem_bytes(int MT, int KSTEP, int nspan) {
  return STAGES * stage_bytes(MT, KSTEP) + nspan * MT * 8 * THREADS * 4;
}

constexpr int kstep_of(int F) { return F % 32 == 0 ? 32 : F % 16 == 0 ? 16 : 8; }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_k16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Four k-rows of one column (stride BN) as one register, row k in byte k.
__device__ __forceinline__ uint32_t col4(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[BN] << 8) | ((uint32_t)p[2 * BN] << 16) |
         ((uint32_t)p[3 * BN] << 24);
}

// Byte offset of (row, column) in a weight chunk: halves swapped on odd
// groups of four rows.
__device__ __forceinline__ int wswz(int row, int col) {
  return row * BN + ((((col >> 4) ^ (row >> 2)) & 1) << 4) + (col & 15);
}

// 16-byte asynchronous copy global -> shared; zeros when !pred.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int MT, bool PACKED, int KSTEP, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
qmm_kernel(const int8_t* __restrict__ x,      // [M, C] int8 activations
           const float* __restrict__ xs,      // [M] activation row scales
           const int8_t* __restrict__ w,      // [C, Wn] this layer's weight bytes
           const float* __restrict__ scale,   // [nG, Wn] this layer's scales
           OutT* __restrict__ out,            // [M, ldo]
           int M, int C, int Wn, int nG, int F, int width, int ldo, int riffle,
           const Splits sp,
           float* __restrict__ ws,            // [tiles, MT * 8, THREADS] running sums (S > 1)
           int* __restrict__ counters) {      // [tiles], 0 between launches (S > 1)
  constexpr int XROWS = 16 * MT;
  constexpr int XLOADS = XROWS * KC / 16 / THREADS;  // 16-byte activation loads per thread
  constexpr int NS = KC / KSTEP;                     // fold-scale slots per chunk
  constexpr int SPIECES = NS * BN / 4;               // their 16-byte pieces
  constexpr int SLOADS = (SPIECES + THREADS - 1) / THREADS;
  constexpr int STAGE = stage_bytes(MT, KSTEP);
  extern __shared__ __align__(16) uint8_t smem[];
  float* sT = reinterpret_cast<float*>(smem + STAGES * STAGE);  // terms [span][MT * 8][THREADS]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // fragment column quad
  const int n_blk = blockIdx.x * BN;
  const int m_blk = blockIdx.y * XROWS;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int r_lo = sp.row[split], r_hi = sp.row[split + 1];
  const int gsz = C / nG;  // rows of one scale group
  const int ncol = warp * 8 + gq;              // shared-memory column of this thread's B fragments
  const int jcol = n_blk + warp * 8 + tq * 2;  // first of this thread's two C columns

  // Chunk c of the split into ring stage st: the weight strip and the scale
  // rows of the folds that end in it (slot j: the fold that ends at row
  // c0 + KSTEP * (j + 1); other slots are left unwritten) ...
  auto issue_w = [&](int c, int st) {
    const int c0 = r_lo + c * KC;
    uint8_t* sB = smem + st * STAGE;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = tid + THREADS * i;
      const int row = idx >> 1, half = idx & 1, r = c0 + row;
      cp16(sB + wswz(row, half * 16),
           r < r_hi ? w + (long long)r * Wn + n_blk + half * 16 : w, r < r_hi);
    }
    float* sS = reinterpret_cast<float*>(sB + KC * BN + XROWS * XS);
#pragma unroll
    for (int i = 0; i < SLOADS; ++i) {
      const int idx = tid + THREADS * i;
      const int end = c0 + KSTEP * (idx / (BN / 4) + 1);
      if (idx < SPIECES && end <= r_hi && end % F == 0)
        cp16(sS + idx * 4,
             scale + (long long)((end - F) / gsz) * Wn + n_blk + (idx % (BN / 4)) * 4, true);
    }
  };
  // ... and its activation rows (the quantizer's output).
  auto issue_x = [&](int c, int st) {
    const int c0 = r_lo + c * KC;
    int8_t* sX = reinterpret_cast<int8_t*>(smem + st * STAGE + KC * BN);
#pragma unroll
    for (int i = 0; i < XLOADS; ++i) {
      const int idx = tid + THREADS * i;
      const int xr = idx / (KC / 16), cc = (idx % (KC / 16)) * 16;
      const bool ok = m_blk + xr < M && c0 + cc < r_hi;
      cp16(sX + xr * XS + cc, ok ? x + (long long)(m_blk + xr) * C + c0 + cc : x, ok);
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

  // Fold the int32 partials of the span that ends at this chunk's scale
  // slot: split 0 into its accumulators, a later split into held terms.
  int nf = 0;
  const float* sS = nullptr;  // the fold scales of the chunk being computed
  auto fold = [&](int slot) {
    const float2 s = *reinterpret_cast<const float2*>(&sS[slot * BN + warp * 8 + tq * 2]);
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
        float te, to = 0.f;
        if (PACKED) {
          te = __fmul_rn((float)(g1[mt][i] - 8 * xr[i >> 1]), sc);
          to = __fmul_rn((float)(g0[mt][i] - g1[mt][i]), sc * 0.0625f);
        } else {
          te = __fmul_rn((float)g0[mt][i], sc);
        }
        if (split == 0) {
          acc_e[mt][i] = __fadd_rn(acc_e[mt][i], te);
          if (PACKED) acc_o[mt][i] = __fadd_rn(acc_o[mt][i], to);
        } else {
          float* t = sT + ((nf * MT + mt) * 8 + i) * THREADS + tid;
          t[0] = te;
          if (PACKED) t[4 * THREADS] = to;
        }
        g0[mt][i] = g1[mt][i] = 0;
      }
      xsum[mt][0] = xsum[mt][1] = 0;
    }
    ++nf;
  };

  const int nch = (r_hi - r_lo + KC - 1) / KC;
  int next_fold = r_lo + F;  // the row at which the current fold span ends
  // The first chunks' weights need nothing from the quantizer launched just
  // before this kernel: they are in flight while it finishes (programmatic
  // dependent launch of split grids; griddepcontrol.wait returns at once
  // without it).
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st)
    if (st < nch) issue_w(st, st);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // x, xs and the workspace are ready
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nch) issue_x(st, st);
    cp_commit();  // one group per stage, empty or not, so the wait count holds
  }
  for (int c = 0; c < nch; ++c) {
    cp_wait<STAGES - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();        // ... every thread's, and chunk c - 1 is consumed
    if (c + STAGES - 1 < nch) {
      issue_w(c + STAGES - 1, (c + STAGES - 1) % STAGES);
      issue_x(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    }
    cp_commit();
    const int c0 = r_lo + c * KC;
    const uint8_t* sB = smem + (c % STAGES) * STAGE;
    const int8_t* sX = reinterpret_cast<const int8_t*>(sB + KC * BN);
    sS = reinterpret_cast<const float*>(sB + KC * BN + XROWS * XS);
    const int rows = min(KC, r_hi - c0);
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      const int k0 = ks * 32;
      if (k0 >= rows) break;  // uniform over the block
      const uint8_t* bp = sB + wswz(k0 + tq * 4, ncol);  // rows +16 share the swizzle
      const uint32_t b0 = col4(bp), b1 = col4(bp + 16 * BN);
      const uint32_t l0 = b0 & 0x0F0F0F0Fu, l1 = b1 & 0x0F0F0F0Fu;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* x0 = &sX[(mt * 16 + gq) * XS + k0 + tq * 4];
        const int8_t* x1 = x0 + 8 * XS;
        a[mt][0] = ld32(x0);
        a[mt][1] = ld32(x1);
        a[mt][2] = ld32(x0 + 16);
        a[mt][3] = ld32(x1 + 16);
      }
      if (KSTEP == 32) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_s8(g0[mt], a[mt], b0, b1);
          if (PACKED) {
            mma_s8(g1[mt], a[mt], l0, l1);
            xsum[mt][0] = __dp4a((int)a[mt][0], 0x01010101, xsum[mt][0]);
            xsum[mt][0] = __dp4a((int)a[mt][2], 0x01010101, xsum[mt][0]);
            xsum[mt][1] = __dp4a((int)a[mt][1], 0x01010101, xsum[mt][1]);
            xsum[mt][1] = __dp4a((int)a[mt][3], 0x01010101, xsum[mt][1]);
          }
        }
        if (c0 + k0 + 32 == next_fold) {
          fold(ks);
          next_fold += F;
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int p = 0; p < (KSTEP == 8 ? 2 : 1); ++p) {
            // KSTEP 8: pass p keeps k 8p .. 8p + 7 of the k16 step (lanes tq < 2 hold k 0-7)
            const bool keep = KSTEP == 16 || (tq >= 2) == (p == 1);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const uint32_t a0 = keep ? a[mt][2 * h] : 0u, a1 = keep ? a[mt][2 * h + 1] : 0u;
              mma_s8_k16(g0[mt], a0, a1, h ? b1 : b0);
              if (PACKED) {
                mma_s8_k16(g1[mt], a0, a1, h ? l1 : l0);
                xsum[mt][0] = __dp4a((int)a0, 0x01010101, xsum[mt][0]);
                xsum[mt][1] = __dp4a((int)a1, 0x01010101, xsum[mt][1]);
              }
            }
            const int end = k0 + 16 * h + (KSTEP == 8 ? 8 * (p + 1) : 16);
            if (c0 + end == next_fold) {
              fold(end / KSTEP - 1);
              next_fold += F;
            }
          }
        }
      }
    }
  }

  if (S > 1) {  // the in-order fold across splits
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* wsp = ws + (long long)tile * (MT * 8 * THREADS) + tid;
    if (split > 0) {
      if (tid == 0) {
        const long long t0 = clock64();
        while (ld_acquire(counters + tile) != split)
          if (clock64() - t0 > 20000000000LL) __trap();  // ~10 s: a lost split, not a wait
      }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_e[mt][i] = __ldcg(wsp + (mt * 8 + i) * THREADS);
          if (PACKED) acc_o[mt][i] = __ldcg(wsp + (mt * 8 + 4 + i) * THREADS);
        }
      }
      for (int f = 0; f < nf; ++f) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* t = sT + ((f * MT + mt) * 8 + i) * THREADS + tid;
            acc_e[mt][i] = __fadd_rn(acc_e[mt][i], t[0]);
            if (PACKED) acc_o[mt][i] = __fadd_rn(acc_o[mt][i], t[4 * THREADS]);
          }
        }
      }
    }
    if (split < S - 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          __stcg(wsp + (mt * 8 + i) * THREADS, acc_e[mt][i]);
          if (PACKED) __stcg(wsp + (mt * 8 + 4 + i) * THREADS, acc_o[mt][i]);
        }
      }
      __syncthreads();  // every thread's sums are written
      if (tid == 0) {
        __threadfence();
        st_release(counters + tile, split + 1);
      }
      return;
    }
    if (tid == 0) counters[tile] = 0;  // the last split: ready for the next launch
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

// Per-row symmetric int8 activations, as ops/qmatmul.py _quantize_rows:
// xs = max(max|x|, 1e-30) * fp32(1/127) (XLA's product with the reciprocal
// of a constant divisor), xi = clamp(round-half-even(x / xs), -127, 127).
// Eight consecutive values (16- or 32-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename InT>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const InT* __restrict__ x, int8_t* __restrict__ xi, float* __restrict__ xs,
                     int C) {
  // The matmul launched after this kernel may start its weight loads now.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float red[8];
  const InT* xr = x + (long long)blockIdx.x * C;
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int c = threadIdx.x * 8; c < C; c += 256 * 8) {  // C % 32 == 0
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
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
  for (int c = threadIdx.x * 8; c < C; c += 256 * 8) {
    float f[8];
    load8(xr + c, f);
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int v = (int)fminf(fmaxf(rintf(__fdiv_rn(f[i], s)), -127.f), 127.f);
      q[i >> 2] |= (uint32_t)(v & 0xFF) << (8 * (i & 3));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(q[0], q[1]);
  }
}

struct Args {
  const int8_t* x;
  const float* xs;
  const int8_t* w;
  const float* scale;
  void* out;
  int M, C, Wn, nG, F, width, ldo, riffle, S;
  Splits sp;
  float* ws;
  int* counters;
};

// The most fold spans one split s > 0 holds as terms.
int held_spans(const Args& a) {
  int n = 0;
  for (int s = 1; s < a.S; ++s) n = max(n, (a.sp.row[s + 1] - a.sp.row[s]) / a.F);
  return n;
}

template <int MT, bool PACKED, int KSTEP, typename OutT>
int launch_mt(const Args& a, cudaStream_t st) {
  auto kernel = qmm_kernel<MT, PACKED, KSTEP, OutT>;
  static bool ready = false;  // one per instance
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int smem = smem_bytes(MT, KSTEP, held_spans(a));
  const dim3 grid(a.Wn / BN, (a.M + 16 * MT - 1) / (16 * MT), a.S);
  if (a.S > 1) {  // a split waits on its predecessor: the whole grid must be resident
    // Resident blocks per SM at this shared memory, queried once per size
    // (smem << 32 | blocks; the launch path is host-bound).
    static std::atomic<long long> occupancy{-1};
    long long known = occupancy.load(std::memory_order_relaxed);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && (known >> 32) != smem) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
      known = ((long long)smem << 32) | per_sm;
      if (e == cudaSuccess) occupancy.store(known, std::memory_order_relaxed);
    }
    if (e != cudaSuccess) return (int)e;
    per_sm = (int)(known & 0xFFFFFFFF);
    if ((long long)per_sm * sms < (long long)grid.x * grid.y * grid.z)
      return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  // Programmatic dependent launch for a split grid: its blocks may start
  // while the quantizer before them in the stream runs, and wait for it
  // (griddepcontrol.wait) only before they read its output. A split grid is
  // small (tiles * S near the SM count) and its launch latency shows; on
  // the large unsplit grids (gate_up, K7) early blocks measured ~8 % slower
  // on an H100.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = a.S > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a.x, a.xs, a.w, a.scale,
                                           static_cast<OutT*>(a.out), a.M, a.C, a.Wn, a.nG, a.F,
                                           a.width, a.ldo, a.riffle, a.sp, a.ws, a.counters);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool PACKED, int KSTEP, typename OutT>
int launch_k(const Args& a, cudaStream_t st) {
  switch (min(4, (a.M + 15) / 16)) {
    case 1: return launch_mt<1, PACKED, KSTEP, OutT>(a, st);
    case 2: return launch_mt<2, PACKED, KSTEP, OutT>(a, st);
    case 3: return launch_mt<3, PACKED, KSTEP, OutT>(a, st);
    default: return launch_mt<4, PACKED, KSTEP, OutT>(a, st);
  }
}

template <bool PACKED, typename OutT>
int launch_t(const Args& a, cudaStream_t st) {
  switch (kstep_of(a.F)) {
    case 32: return launch_k<PACKED, 32, OutT>(a, st);
    case 16: return launch_k<PACKED, 16, OutT>(a, st);
    default: return launch_k<PACKED, 8, OutT>(a, st);
  }
}

template <bool PACKED>
int launch(const void* x, const void* xs, const void* w, const void* scale, void* out,
           int out_fp32, int M, int C, int Wn, int nG, int F, int layer, int width, int ldo,
           int riffle, const int* rows, int S, void* ws, void* counters, void* stream) {
  if (M < 1 || M > 256 || C % 32 || nG < 1 || C % nG || (C / nG) % 8 || F % 8 || F < 8 ||
      C % F || Wn % BN || width < 1 || ldo < width || S < 1 || S > MAX_SPLITS || !rows ||
      (S > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int8_t*>(x),
         static_cast<const float*>(xs),
         static_cast<const int8_t*>(w) + (long long)layer * C * Wn,
         static_cast<const float*>(scale) + (long long)layer * nG * Wn,
         out, M, C, Wn, nG, F, width, ldo, riffle, S, {}, static_cast<float*>(ws),
         static_cast<int*>(counters)};
  // The splits: whole fold spans on 32-row steps, in order, covering [0, C).
  if (rows[0] != 0 || rows[S] != C) return (int)cudaErrorInvalidValue;
  for (int s = 0; s <= S; ++s) {
    if (rows[s] % 32 || rows[s] % F || (s > 0 && rows[s] <= rows[s - 1]))
      return (int)cudaErrorInvalidValue;
    a.sp.row[s] = rows[s];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_fp32) return launch_t<PACKED, float>(a, st);
  return launch_t<PACKED, __nv_bfloat16>(a, st);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The activation quantizer of K6 and K7: x [M, C] bf16 (or fp32 when
// x_fp32) -> xi [M, C] int8, xs [M] fp32.
extern "C" int qmm_quantize_rows(const void* x, int x_fp32, void* xi, void* xs, int M, int C,
                                 void* stream) {
  if (M < 1 || C < 1 || C % 32) return (int)cudaErrorInvalidValue;
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
// rows [S + 1] (host memory): the splits' contraction rows, from
// ops/qmatmul.py plan_splits; ws / counters: the split workspace of the
// stream (counters 0), unused when S = 1.
extern "C" int qmm_w4a8(const void* x, const void* xs, const void* w, const void* scale,
                        void* out, int out_fp32, int M, int C, int Wn, int nG, int F, int layer,
                        int width, int ldo, int riffle, const int* rows, int S, void* ws,
                        void* counters, void* stream) {
  return launch<true>(x, xs, w, scale, out, out_fp32, M, C, Wn, nG, F, layer, width, ldo,
                      riffle, rows, S, ws, counters, stream);
}

// K7: int8 weights.
extern "C" int qmm_w8a8(const void* x, const void* xs, const void* w, const void* scale,
                        void* out, int out_fp32, int M, int C, int Wn, int nG, int F, int layer,
                        int width, int ldo, int riffle, const int* rows, int S, void* ws,
                        void* counters, void* stream) {
  return launch<false>(x, xs, w, scale, out, out_fp32, M, C, Wn, nG, F, layer, width, ldo,
                       riffle, rows, S, ws, counters, stream);
}

// Dynamic shared memory of one block at MT row tiles, fold span F and nspan
// held spans (chip_smoke.py prints it beside each case).
extern "C" int qmm_smem_bytes(int MT, int F, int nspan) {
  return smem_bytes(MT, kstep_of(F), nspan);
}
