// W4A8 and W8A8 weight matmuls for Hopper (sm_90a): K6 (qmm_kernel) and K7
// (w8a8_kernel), with the activation quantizer they share; and K9
// (w4a16_kernel), the W4A16 grouped matmul under 512 rows.
//
// Replaces the TPU kernels of lite_llama_tpu/ops/qmatmul.py:
// - K6, quantized_matmul_packed -> _qmm_kernel: int8 activations [M, C]
//   against packed int4 weight bytes [Lf, C, Wn] (byte = 16*hi + (lo + 8),
//   paired fp32 scales [Lf, nG, Wn]). Per scale group the kernel runs the
//   TPU kernel's integer identity on the RAW bytes:
//       g0 = x . b,  g1 = x . (b & 0x0F)          (exact int32 dots)
//       acc_e += (g1 - 8 * sum(x_g)) * s          (even / lo columns)
//       acc_o += (g0 - g1) * (s * 0.0625)         (odd / hi columns)
//   and multiplies by the row's activation scale on the way out.
// - K7, quantized_matmul_int8 -> _qmm8_kernel: int8 weights [Lf, C, Wn];
//   acc += (x . w) * s per group.
// Per-channel weights (nG = 1) fold at every F-row contraction block, the
// TPU kernel's C block, so the fp32 sums are taken in its order; the fold
// uses __fmul_rn / __fadd_rn (no fused multiply-add) and matches the plain
// version (ops/qmatmul.py) bit for bit.
//
// What bounds both: device-memory bytes. At decode (M = 12..64 rows) every
// weight byte is read once for 2*M integer operations, far below the ~590
// int8 operations per byte at which the tensor cores would be the limit
// (M = 256 comes within 2x of it). So the levers are SMs streaming, weight
// bytes in flight, and few instructions per weight byte.
//
// K6 (qmm_kernel):
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
//   and on b & 0x0F0F0F0F (one 32-bit AND per four bytes).
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
//   one launch where PyTorch's eager ops take nine; or they arrive quantized
//   by the norm or SwiGLU that wrote them (csrc/norms.cu emits the int8 rows
//   in the same pass, with the same rounding, common.cuh). A split matmul
//   grid is launched as a programmatic dependent of the kernel before it:
//   its blocks start while that kernel runs, put their first weight chunks
//   in flight, and wait (griddepcontrol.wait) only before they read the
//   quantized rows.
// - A fold check compares the row reached with the next span's end (no
//   integer division in the k-step loop).
// - The epilogue writes straight into the final columns: classic packing
//   interleaved (2j, 2j+1), riffle packing [evens | odds], pad columns past
//   the logical width skipped, bf16 or fp32.
//
// K7 (w8a8_kernel), designed for the weight stream alone:
// - Strips of 128 weight bytes (columns): each weight row a block reads is
//   128 contiguous bytes. The grid is (row tiles, strips, splits); the row
//   tiles of one strip run side by side and share its bytes in L2.
// - A producer warp and 4 * KW consumer warps. One producer thread streams
//   every chunk (128 * KW rows of the strip) by TMA into a ring of stages:
//   the weight tile, the activation tiles and the scale row of each fold
//   that ends in the chunk, all counted on the stage's full barrier; the
//   consumers give the stage back through its empty barrier. A chunk costs
//   the producer a handful of instructions (per-thread cp.async copies with
//   their address and predicate arithmetic held one block to ~20 GB/s on an
//   H100 whatever the ring's depth). The tensor maps' encoder is looked up
//   at run time (cudaGetDriverEntryPoint): no link against libcuda.
// - Weight fragments from 32-bit shared loads and byte permutes: consumer
//   warp cw's 32 columns are four n8 tiles over interleaved columns (tile
//   j: columns 4g + j), so one lane's 32-bit load is four neighbouring
//   columns of one k-row, one per tile; a 4 x 4 byte transpose (prmt) of
//   four such loads gives each tile its B register (four k-rows of one
//   column). Per 32-row k-step a lane makes 8 shared loads for 4 mma (K6: 8
//   byte loads for 1), and one A fragment feeds the four tiles. Under the
//   TMA's 128-byte swizzle, lanes tq >= 2 load their rows 0-1 and 2-3 in
//   swapped order (undone by their own prmt selectors), so a load's 32
//   lanes hit 32 banks.
// - More warps on a strip: with KW = 2 each column has two k-warps, taking
//   rows [0, 128) and [128, 256) of every chunk; at the chunk's end k-warp
//   1 hands its int32 dots to k-warp 0 through shared memory (a named
//   barrier per column, two slots alternating), which folds, in row order,
//   the spans that end at either half. An int32 sum is exact in any order,
//   so the fp32 folds, and bit-equality, stand. It needs fold spans of
//   whole 128-row runs.
// - Splits over C (S > 1, whole chunks, at most 8): the S splits of a tile
//   are a thread-block cluster. Split s > 0 holds its spans' fp32 terms,
//   waits for split s - 1's running sums to arrive in its own shared memory
//   (written there by s - 1 through distributed shared memory, then an
//   arrival on s's barrier), continues them in order and hands them to
//   s + 1; the last split writes the output. No workspace, no counter.
// - The launch is the quantizer's programmatic dependent: the first weight
//   tiles are in flight while the quantizer finishes.
// - The epilogue puts the interleaved columns back: fragment i of tile j
//   is column 8 tq + 4 (i & 1) + j, so a lane writes 4 + 4 neighbouring
//   columns of a row as two vector stores.
//
// K9 (w4a16_kernel) replaces no Pallas kernel. The JAX package leaves this
// product to XLA (lite_llama_tpu/quant/qtensor.py:639-661, the small-M
// grouped branch of qeinsum): per scale group g and nibble half,
//     y_h[m, o] = sum_g (sum_{c in g} x[m, c] * h[c, o]) * scale[g, o]
// in fp32, with bf16 x and the integers -8..7 (their products are exact in
// fp32). XLA fuses the int4 -> bf16 convert into the dot; plain PyTorch
// cannot, and wrote an int8, a bf16 and an fp32 copy of every half before
// a bmm (ROADMAP C8: an int4 decode step slower than bf16 wherever the
// routing rule keeps a projection off K6: C not a multiple of 8 groups
// above 4096 rows, Falcon3-7B's, Qwen2.5-3B's, Qwen3-4B's and Vicuna-7B's
// down, and every projection at 257-511 rows).
// - What bounds it: at decode (M = 5..16) the weight bytes, read once (2 M
//   bf16 operations per weight, far below the card's ~295 per byte); near
//   512 rows the bf16 operations.
// - Each byte is read once and gives both nibbles: 0x4300 | n is the bf16
//   of 128 + n, so a mask, an xor (the high nibble is two's complement) and
//   one bf16x2 subtraction of 136 turn two nibbles into the exact bf16 pair
//   (n - 8); mma.sync m16n8k16 bf16 -> fp32 takes them. The mma's k index
//   is a permutation of the step's 16 rows chosen so that a lane's four
//   bytes of a column are four neighbouring rows (one 32-bit shared load
//   each for four columns, a byte permute per pair of rows) and its
//   activations four neighbouring values of a row (one 64-bit load).
// - One accumulator per group, as JAX's per-group dot: at the group's end
//   it is multiplied by the group's fp32 scale (the scale rows ride the
//   ring with the chunk) and added into the running sum.
// - A block is 64 byte columns (two warp slabs of 32) by 16 or 32 rows;
//   its 8 warps are 2 slabs x 4 k-lanes, k-lane l taking rows [16 l, 16 l +
//   16) of every 64-row chunk. A cp.async ring of 8 stages holds each
//   chunk's weights, activations and scale rows (28 KB of weights in
//   flight per block); weight rows go to shared memory in groups of four
//   rotated by the group's index, so the rows four apart that a lane quad
//   reads hit 32 different banks.
// - The card fills by splitting the groups of C: where the output tiles
//   leave SMs idle, S splits (at most 8) of whole groups, ragged where S
//   does not divide nG (86 = 2 x 43 groups: spans of 10 and 11), one
//   thread-block cluster per output tile. The k-lanes' sums are added in
//   k-lane order, then the splits' in split order, each block adding its
//   share of the tile's outputs from every block's shared memory: fixed
//   order, no atomics, no workspace, nothing kept between launches, so a
//   replayed CUDA graph gives the eager launch's bits.

#include <atomic>

#include "common.cuh"  // mbarriers, TMA, PDL launches, the int8 row rounding

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

__device__ __forceinline__ uint32_t ld32(const void* p) {
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

template <int MT, int KSTEP, typename OutT>
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
        const float te = __fmul_rn((float)(g1[mt][i] - 8 * xr[i >> 1]), sc);
        const float to = __fmul_rn((float)(g0[mt][i] - g1[mt][i]), sc * 0.0625f);
        if (split == 0) {
          acc_e[mt][i] = __fadd_rn(acc_e[mt][i], te);
          acc_o[mt][i] = __fadd_rn(acc_o[mt][i], to);
        } else {
          float* t = sT + ((nf * MT + mt) * 8 + i) * THREADS + tid;
          t[0] = te;
          t[4 * THREADS] = to;
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
          mma_s8(g1[mt], a[mt], l0, l1);
          xsum[mt][0] = __dp4a((int)a[mt][0], 0x01010101, xsum[mt][0]);
          xsum[mt][0] = __dp4a((int)a[mt][2], 0x01010101, xsum[mt][0]);
          xsum[mt][1] = __dp4a((int)a[mt][1], 0x01010101, xsum[mt][1]);
          xsum[mt][1] = __dp4a((int)a[mt][3], 0x01010101, xsum[mt][1]);
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
              mma_s8_k16(g1[mt], a0, a1, h ? l1 : l0);
              xsum[mt][0] = __dp4a((int)a0, 0x01010101, xsum[mt][0]);
              xsum[mt][1] = __dp4a((int)a1, 0x01010101, xsum[mt][1]);
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
          acc_o[mt][i] = __ldcg(wsp + (mt * 8 + 4 + i) * THREADS);
        }
      }
      for (int f = 0; f < nf; ++f) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* t = sT + ((f * MT + mt) * 8 + i) * THREADS + tid;
            acc_e[mt][i] = __fadd_rn(acc_e[mt][i], t[0]);
            acc_o[mt][i] = __fadd_rn(acc_o[mt][i], t[4 * THREADS]);
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
          __stcg(wsp + (mt * 8 + 4 + i) * THREADS, acc_o[mt][i]);
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
      const int ce = riffle ? j : 2 * j;
      const int co = riffle ? Wn + j : 2 * j + 1;
      if (ce < width) store(orow + ce, __fmul_rn(acc_e[mt][i], xr));
      if (co < width) store(orow + co, __fmul_rn(acc_o[mt][i], xr));
    }
  }
}

// Per-row symmetric int8 activations (common.cuh quant_scale / quant_int8),
// one block per row.
template <typename InT>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const InT* __restrict__ x, int8_t* __restrict__ xi, float* __restrict__ xs,
                     int C) {
  // The matmul launched after this kernel may start its weight loads now.
  pdl_launch_dependents();
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
  const float s = quant_scale(amax);
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
  int8_t* qr = xi + (long long)blockIdx.x * C;
  for (int c = threadIdx.x * 8; c < C; c += 256 * 8) {
    float f[8];
    load8(xr + c, f);
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int v = quant_int8(f[i], s);
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
  int M, C, Wn, nG, F, width, ldo, riffle, S, kw;  // kw: K7's k-warps
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  ready = e == cudaSuccess;
  return e;
}

template <int MT, int KSTEP, typename OutT>
int launch_mt(const Args& a, cudaStream_t st) {
  auto kernel = qmm_kernel<MT, KSTEP, OutT>;
  static bool ready = false;  // one per instance
  const cudaError_t ready_e = allow_smem(kernel, ready);
  if (ready_e != cudaSuccess) return (int)ready_e;
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
  // the large unsplit grids (gate_up) early blocks measured ~8 % slower on
  // an H100.
  const cudaError_t e =
      launch_kernel(kernel, {grid, dim3(THREADS), smem, st, a.S > 1}, a.x, a.xs, a.w, a.scale,
                    static_cast<OutT*>(a.out), a.M, a.C, a.Wn, a.nG, a.F, a.width, a.ldo,
                    a.riffle, a.sp, a.ws, a.counters);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int KSTEP, typename OutT>
int launch_k(const Args& a, cudaStream_t st) {
  switch (min(4, (a.M + 15) / 16)) {
    case 1: return launch_mt<1, KSTEP, OutT>(a, st);
    case 2: return launch_mt<2, KSTEP, OutT>(a, st);
    case 3: return launch_mt<3, KSTEP, OutT>(a, st);
    default: return launch_mt<4, KSTEP, OutT>(a, st);
  }
}

template <typename OutT>
int launch_t(const Args& a, cudaStream_t st) {
  switch (kstep_of(a.F)) {
    case 32: return launch_k<32, OutT>(a, st);
    case 16: return launch_k<16, OutT>(a, st);
    default: return launch_k<8, OutT>(a, st);
  }
}

// ---------------------------------------------------------------------------
// K7: the W8A8 kernel (int8 weights), its own design.

constexpr int W8_BN = 128;     // byte columns of a strip: four column warps of 32
constexpr int W8_RANGE = 128;  // rows of a chunk each k-warp takes (four 32-row steps)
constexpr int W8_MAX_SPLITS = 8;  // a portable cluster (ops/qmatmul.py _W8_MAX_SPLITS)

// Ring stages: 64 KB of weights in the ring at one k-warp, 96 KB at two.
__host__ __device__ constexpr int w8_stages(int KW) { return KW == 1 ? 4 : 3; }

// Dynamic shared memory of one K7 block (ops/qmatmul.py _w8_smem_bytes):
// 1 KB to align the tiles (the 128-byte TMA swizzle repeats every 1 KB),
// per stage the weight tile (KC = 128 * KW rows of 128 bytes), the
// activation tiles (KW of 16 * MT rows x 128 bytes), the fold-scale slots
// (a 128-float row per KSTEP rows) and the full and empty barriers; the
// split hand-over's barrier; the k-warps' int32 exchange (two slots at two
// k-warps), the slot the previous split's sums arrive in and the fp32 terms
// of nspan held fold spans (splits s > 0); a slot is one fragment set of
// the 128 accumulator threads (16 * MT words each).
__host__ __device__ constexpr int w8_smem_bytes(int MT, int KSTEP, int KW, int nspan) {
  return 1024 + 16 +
         w8_stages(KW) * (W8_RANGE * KW * W8_BN + KW * 16 * MT * W8_BN +
                          (W8_RANGE * KW / KSTEP) * W8_BN * 4 + 16) +
         (2 * (KW - 1) + 1 + nspan) * 16 * MT * W8_BN * 4;
}

// A 4 x 4 byte transpose: w[r] holds byte columns c = 0..3 of k-row r (rows
// 0-1 and 2-3 trade places when `swapped`); b[c] gets k-rows 0..3 of column
// c (row r in byte r), an mma B register. The second stage's selectors are
// the lane's own (f_lo 0x5410 / 0x1054, f_hi 0x7632 / 0x3276), so the swap
// costs nothing.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&b)[4],
                                           uint32_t f_lo, uint32_t f_hi) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);  // the same of rows 2-3
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  b[0] = __byte_perm(t0, t2, f_lo);
  b[1] = __byte_perm(t0, t2, f_hi);
  b[2] = __byte_perm(t1, t3, f_lo);
  b[3] = __byte_perm(t1, t3, f_hi);
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
// Arrives on a barrier in another block of the cluster, after (release)
// this thread's stores to it.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits for phase 0 of a barrier that other blocks of the cluster arrive on.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > 20000000000LL) __trap();  // ~10 s: a lost split, not a wait
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// Grid (row tiles, Wn / 128 strips, S splits); 32 * (4 KW + 1) threads:
// consumer warp w = cw + 4 kw (column warp cw, k-warp kw) and, last, the
// producer warp. Column warp cw owns byte columns [32 cw, 32 cw + 32) of the
// strip as four n8 tiles over interleaved columns (tile j: columns 4 g + j);
// k-warp kw takes rows [128 kw, 128 kw + 128) of every chunk. KW 2 needs
// fold spans of whole 128-row runs. Splits are whole chunks.
template <int MT, int KSTEP, int KW, typename OutT>
__global__ void __launch_bounds__(32 * (4 * KW + 1))
w8a8_kernel(const __grid_constant__ CUtensorMap wmap,  // this layer's weights [C, Wn]
            const __grid_constant__ CUtensorMap xmap,  // int8 activations [M, C]
            const __grid_constant__ CUtensorMap smap,  // this layer's scales [nG, Wn]
            const float* __restrict__ xs,      // [M] activation row scales
            OutT* __restrict__ out,            // [M, Wn]
            int M, int C, int Wn, int nG, int F, const Splits sp) {
  constexpr int BN = W8_BN;
  constexpr int KC = W8_RANGE * KW;  // contraction rows per chunk
  constexpr int ST = w8_stages(KW);
  constexpr int CONS = 4 * KW;       // consumer warps
  constexpr int NS = KC / KSTEP;     // fold-scale slots per chunk
  constexpr int WBYTES = KC * BN;
  constexpr int ATILE = 16 * MT * BN;  // one k-warp's activation tile
  constexpr int SBYTES = NS * BN * 4;
  constexpr int FRAG = 16 * MT;  // int32 dots / fp32 sums per thread
  static_assert(KSTEP == 32 || KW == 1, "k-warps need 32-row k-steps");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sA = smem + ST * WBYTES;              // [ST][KW] activation tiles
  uint8_t* sSc = sA + ST * KW * ATILE;           // [ST] fold-scale slots
  uint64_t* full = reinterpret_cast<uint64_t*>(sSc + ST * SBYTES);
  uint64_t* empty = full + ST;
  uint64_t* handed = empty + ST;  // the previous split's sums are in sIn
  int* sE = reinterpret_cast<int*>(handed + 2);                // [2][FRAG][128] (KW 2)
  float* sIn = reinterpret_cast<float*>(sE + 2 * (KW - 1) * FRAG * BN);  // [128][FRAG]
  float* sT = sIn + FRAG * BN;                                 // [span][FRAG][128]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row group
  const int tq = lane & 3;   // fragment column quad
  const int cw = warp & 3;
  const int kw = KW == 1 ? 0 : warp >> 2;
  const int own = cw * 32 + lane;
  const int m_blk = blockIdx.x * 16 * MT;
  const int n_blk = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int r_lo = sp.row[split], r_hi = sp.row[split + 1];
  const int nch = (r_hi - r_lo + KC - 1) / KC;
  const bool producer = warp == CONS;

  if (tid == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 2);      // the producer's two arrivals with the stage's bytes
      mbar_init(&empty[st], CONS);  // one arrival per consumer warp
    }
    mbar_init(handed, BN);  // one arrival per accumulator thread of the previous split
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // A split grid is a cluster of the S splits of one tile: every block's
  // barriers are initialised before any other block may arrive on them.
  if (S > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // The producer (one thread): chunk c into stage c % ST by TMA, the weight
  // tile, the activation tiles and the scale row of every fold that ends in
  // the chunk (slot j: the fold that ends at row c0 + KSTEP * (j + 1)). The
  // tensor maps zero-fill past C and past M; splits are whole chunks, so
  // nothing past r_hi but C's end is read.
  int next_end = r_lo + F, next_group = nG > 1 ? r_lo / F : 0;  // the next fold's end row and scale row
  auto load_chunk = [&](int c, bool weights, bool rest) {
    const int st = c % ST, c0 = r_lo + c * KC, c1 = min(c0 + KC, r_hi);
    if (weights) {
      mbar_expect(&full[st], WBYTES);
      tma_load_2d(smem + st * WBYTES, &wmap, n_blk, c0, &full[st]);
    }
    if (rest) {
      int folds = 0;
      for (int e = next_end; e <= c1; e += F) ++folds;
      mbar_expect(&full[st], KW * ATILE + folds * BN * 4);
#pragma unroll
      for (int k = 0; k < KW; ++k)
        tma_load_2d(sA + (st * KW + k) * ATILE, &xmap, c0 + k * W8_RANGE, m_blk, &full[st]);
      for (; next_end <= c1; next_end += F, next_group += nG > 1 ? 1 : 0)
        tma_load_2d(sSc + st * SBYTES + ((next_end - c0) / KSTEP - 1) * BN * 4, &smap, n_blk,
                    next_group, &full[st]);
    }
  };
  // Each stage's barrier completes with two arrivals of the producer (the
  // weights, then the rest) and all their bytes.
  if (producer && lane == 0) {
    // The first chunks' weights need nothing from the quantizer launched just
    // before this kernel: they are in flight while it finishes.
    for (int c = 0; c < ST && c < nch; ++c) load_chunk(c, true, false);
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // x, xs and the workspace are ready
  if (producer && lane == 0) {
    for (int c = 0; c < nch; ++c) {
      if (c >= ST) mbar_wait(&empty[c % ST], (c / ST - 1) & 1);  // chunk c - ST is consumed
      load_chunk(c, c >= ST, true);
    }
  }
  __syncwarp();  // the producer warp reconverges before any block barrier

  int g[MT][4][4];      // int32 dots of the open fold span [row tile][n8 tile][fragment]
  float acc[MT][4][4];  // fp32 running sums (k-warp 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        g[mt][j][i] = 0;
        acc[mt][j][i] = 0.f;
      }

  // Fold the span that just ended with the scales of slot `slot` of the
  // chunk's stage (k-warp 0): split 0 into its accumulators, a later split
  // into held terms.
  int nf = 0;
  auto fold = [&](const float* sS, int slot) {
    // Columns 8 tq + 4 h + j of the column warp: fragment i of tile j
    // holds column 4 (2 tq + (i & 1)) + j.
    const float4 s0 = *reinterpret_cast<const float4*>(&sS[slot * BN + cw * 32 + tq * 8]);
    const float4 s1 = *reinterpret_cast<const float4*>(&sS[slot * BN + cw * 32 + tq * 8 + 4]);
    const float sc[2][4] = {{s0.x, s0.y, s0.z, s0.w}, {s1.x, s1.y, s1.z, s1.w}};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float t = __fmul_rn((float)g[mt][j][i], sc[i & 1][j]);
          if (split == 0)
            acc[mt][j][i] = __fadd_rn(acc[mt][j][i], t);
          else
            sT[(nf * FRAG + (mt * 4 + j) * 4 + i) * BN + own] = t;
          g[mt][j][i] = 0;
        }
    ++nf;
  };

  if (!producer) {
    // Per-thread shared-memory offsets: the weight row 4 tq + i' of a 32-row
    // step under the TMA's 128-byte swizzle (16-byte piece p of row r at
    // piece p ^ (r & 7)), where lanes tq >= 2 read rows 0-1 and 2-3 traded
    // (i' = i ^ 2), so the 32 lanes of a load hit 32 banks; a step only adds
    // its first row times 128. And the activation words.
    const bool swapped = tq >= 2;
    const uint32_t f_lo = swapped ? 0x1054 : 0x5410, f_hi = swapped ? 0x3276 : 0x7632;
    int b_row[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tq * 4 + (i ^ (swapped ? 2 : 0)), col = cw * 32 + gq * 4;
      b_row[i] = r * BN + ((((col >> 4) ^ (r & 7)) << 4) | (col & 15)) + kw * W8_RANGE * BN;
    }
    // The activation tiles carry the same swizzle: row r (r & 7 = gq) holds
    // the 16-byte piece p of its 128 columns at piece p ^ gq.
    const int a_row = gq * BN + tq * 4, a_swz = gq << 4;
    int next_fold = r_lo + F;  // the row at which the current fold span ends
    for (int c = 0; c < nch; ++c) {
      const int st = c % ST;
      mbar_wait(&full[st], (c / ST) & 1);
      const int c0 = r_lo + c * KC;
      const uint8_t* bB = smem + st * WBYTES;
      const uint8_t* aX = sA + (st * KW + kw) * ATILE + a_row;
      const float* sS = reinterpret_cast<const float*>(sSc + st * SBYTES);
      // No early exit: a last chunk's rows past C are zeros, so its steps add
      // exact zeros, and the loop stays straight-line code whose loads the
      // compiler can hoist.
#pragma unroll
      for (int s4 = 0; s4 < W8_RANGE / 32; ++s4) {
        const int k0 = s4 * 32;  // the step's first row within this k-warp's range
        uint32_t b[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = ld32(bB + (k0 + 16 * h) * BN + b_row[i]);
          transpose4(v, b[h], f_lo, f_hi);
        }
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint8_t* x0 = aX + mt * 16 * BN;  // rows gq and gq + 8 share the swizzle
          a[mt][0] = ld32(x0 + ((k0 & ~15) ^ a_swz));
          a[mt][1] = ld32(x0 + 8 * BN + ((k0 & ~15) ^ a_swz));
          a[mt][2] = ld32(x0 + ((k0 + 16) ^ a_swz));
          a[mt][3] = ld32(x0 + 8 * BN + ((k0 + 16) ^ a_swz));
        }
        if (KSTEP == 32) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(g[mt][j], a[mt], b[0][j], b[1][j]);
          if (KW == 1 && c0 + k0 + 32 == next_fold && next_fold <= r_hi) {
            fold(sS, k0 / 32);
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
#pragma unroll
                for (int j = 0; j < 4; ++j) mma_s8_k16(g[mt][j], a0, a1, b[h][j]);
              }
              const int end = k0 + 16 * h + (KSTEP == 8 ? 8 * (p + 1) : 16);
              if (c0 + end == next_fold && next_fold <= r_hi) {
                fold(sS, end / KSTEP - 1);
                next_fold += F;
              }
            }
          }
        }
      }
      if (KW > 1) {
        // k-warp 1 hands its int32 dots to k-warp 0 (an exact sum in any
        // order), which folds, in row order, any span that ends at its own
        // range's end and then any that ends at the chunk's. Slot c & 1 is
        // written again two chunks later, after the next barrier, which
        // k-warp 0 reaches only once it has read it.
        int* e = sE + (c & 1) * FRAG * BN + own;
        if (kw > 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                e[((mt * 4 + j) * 4 + i) * BN] = g[mt][j][i];
                g[mt][j][i] = 0;
              }
        }
        bar_sync(1 + cw, 64);
        if (kw == 0) {
          if (c0 + W8_RANGE == next_fold && next_fold <= r_hi) {
            fold(sS, W8_RANGE / 32 - 1);
            next_fold += F;
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) g[mt][j][i] += e[((mt * 4 + j) * 4 + i) * BN];
          if (c0 + KC == next_fold && next_fold <= r_hi) {
            fold(sS, KC / 32 - 1);
            next_fold += F;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    }
  }

  if (S > 1) {
    // The in-order fold across splits, through the cluster: split s > 0
    // takes the running sums split s - 1 wrote into its sIn, continues them
    // with its held terms, in order, and writes them into split s + 1's sIn
    // (each accumulator thread its own, then an arrival on s + 1's barrier);
    // the last split writes the output. Every float is rounded as the plain
    // version rounds it.
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (!producer && kw == 0) {
      float4* in = reinterpret_cast<float4*>(sIn + own * FRAG);
      if (split > 0) {
        mbar_wait_cluster(handed);
#pragma unroll
        for (int v = 0; v < FRAG / 4; ++v) {  // acc[mt][j][0..3] is in[4 mt + j]
          const float4 t = in[v];
          acc[v >> 2][v & 3][0] = t.x, acc[v >> 2][v & 3][1] = t.y;
          acc[v >> 2][v & 3][2] = t.z, acc[v >> 2][v & 3][3] = t.w;
        }
        for (int f = 0; f < nf; ++f)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[mt][j][i] = __fadd_rn(acc[mt][j][i],
                                          sT[(f * FRAG + (mt * 4 + j) * 4 + i) * BN + own]);
      }
      if (split < S - 1) {
        const uint32_t to = cluster_addr(in, split + 1);
#pragma unroll
        for (int v = 0; v < FRAG / 4; ++v)
          st_cluster(to + 16 * v, make_float4(acc[v >> 2][v & 3][0], acc[v >> 2][v & 3][1],
                                              acc[v >> 2][v & 3][2], acc[v >> 2][v & 3][3]));
        mbar_arrive_cluster(cluster_addr(handed, split + 1));
      }
    }
    if (split < S - 1) return;
  }
  if (producer || kw != 0) return;

  // Fragment (mt, j, i) is row gq + 8 (i >> 1) and column 8 tq + 4 (i & 1) + j
  // of the column warp: each thread writes 4 + 4 neighbouring columns a row.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m_blk + mt * 16 + gq + 8 * r;
      if (row >= M) continue;
      const float xr = xs[row];
      OutT* o = out + (long long)row * Wn + n_blk + cw * 32 + tq * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(acc[mt][j][2 * r + h], xr);
        store4(o + 4 * h, v);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// libcuda); null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

template <int MT, int KSTEP, int KW, typename OutT>
int launch_w8(const Args& a, cudaStream_t st) {
  auto kernel = w8a8_kernel<MT, KSTEP, KW, OutT>;
  static bool ready = false;  // one per instance
  cudaError_t e = allow_smem(kernel, ready);
  if (e != cudaSuccess) return (int)e;
  // Tensor maps: the layer's weights (rows of Wn bytes; tiles of a chunk's
  // 128 * KW rows x 128 bytes), the int8 activations (rows of C bytes;
  // tiles of 16 * MT rows x 128 bytes), both with the 128-byte swizzle, and
  // the layer's scales (rows of Wn floats; tiles of one row x 128).
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap wmap, xmap, smap;
  const cuuint32_t elem[2] = {1, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)a.Wn, (cuuint64_t)a.C}, wstride[1] = {(cuuint64_t)a.Wn};
  const cuuint64_t xdims[2] = {(cuuint64_t)a.C, (cuuint64_t)a.M}, xstride[1] = {(cuuint64_t)a.C};
  const cuuint64_t sdims[2] = {(cuuint64_t)a.Wn, (cuuint64_t)a.nG},
                   sstride[1] = {(cuuint64_t)a.Wn * 4};
  const cuuint32_t wbox[2] = {W8_BN, W8_RANGE * KW}, xbox[2] = {W8_BN, 16 * MT},
                   sbox[2] = {W8_BN, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(a.w), wdims, wstride,
             wbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(a.x), xdims, xstride,
             xbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a.scale), sdims,
             sstride, sbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int smem = w8_smem_bytes(MT, KSTEP, KW, held_spans(a));
  // Row tiles fastest: the blocks that read one strip run together (L2). The
  // S splits of a tile form a cluster, scheduled together.
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (a.S > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = 1;
    attr[n].val.clusterDim.y = 1;
    attr[n++].val.clusterDim.z = a.S;
  }
  // Always a programmatic dependent of the quantizer: the producer's first
  // weight tiles are in flight while it finishes (~1 us on an H100).
  attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[n++].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.M + 16 * MT - 1) / (16 * MT), a.Wn / W8_BN, a.S);
  cfg.blockDim = dim3(32 * (4 * KW + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  e = cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, smap, a.xs, static_cast<OutT*>(a.out), a.M,
                         a.C, a.Wn, a.nG, a.F, a.sp);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int MT, int KSTEP, typename OutT>
int launch_w8_kw(const Args& a, cudaStream_t st) {
  if constexpr (KSTEP == 32)
    if (a.kw == 2) return launch_w8<MT, KSTEP, 2, OutT>(a, st);
  if (a.kw != 1) return (int)cudaErrorInvalidValue;
  return launch_w8<MT, KSTEP, 1, OutT>(a, st);
}

template <int KSTEP, typename OutT>
int launch_w8_k(const Args& a, cudaStream_t st) {
  switch (min(4, (a.M + 15) / 16)) {
    case 1: return launch_w8_kw<1, KSTEP, OutT>(a, st);
    case 2: return launch_w8_kw<2, KSTEP, OutT>(a, st);
    case 3: return launch_w8_kw<3, KSTEP, OutT>(a, st);
    default: return launch_w8_kw<4, KSTEP, OutT>(a, st);
  }
}

template <typename OutT>
int launch_w8_t(const Args& a, cudaStream_t st) {
  switch (kstep_of(a.F)) {
    case 32: return launch_w8_k<32, OutT>(a, st);
    case 16: return launch_w8_k<16, OutT>(a, st);
    default: return launch_w8_k<8, OutT>(a, st);
  }
}

// ---------------------------------------------------------------------------
// K9: the W4A16 grouped matmul under 512 rows (w4a16_kernel), its own design.

constexpr int W4_BN = 64;       // byte columns of a block: two warp slabs of 32
constexpr int W4_SLAB = 32;     // byte columns of a warp
constexpr int W4_KL = 4;        // k-lanes: the warps of a slab, one 16-row step of a chunk each
constexpr int W4_WARPS = 2 * W4_KL;
constexpr int W4_THREADS = 32 * W4_WARPS;
constexpr int W4_KC = 16 * W4_KL;         // contraction rows per chunk
constexpr int W4_XS = 2 * W4_KC + 32;     // bytes per activation row of a chunk (+32: no conflicts)
constexpr int W4_SLOTS = 4;               // scale rows per chunk: groups of 16 rows touch 4
constexpr int W4_STAGES = 8;              // ring stages
constexpr int W4_MAX_SPLITS = 8;          // a portable cluster (ops/qmatmul.py _W4_MAX_SPLITS)

// One ring stage: the weight chunk (W4_KC rows x W4_BN bytes, one 2 KB slab
// per warp column), 16 * MT activation rows and W4_SLOTS scale rows.
__host__ __device__ constexpr int w4_stage_bytes(int MT) {
  return W4_KC * W4_BN + 16 * MT * W4_XS + W4_SLOTS * W4_BN * 4;
}

// Dynamic shared memory of one K9 block: the ring, which the k-lanes' fp32
// sums (4 x 16 * MT rows x 2 halves x W4_BN floats) reuse after the last
// chunk (61,440 bytes at MT 1: two blocks fit an SM).
__host__ __device__ constexpr int w4_smem_bytes(int MT) {
  return W4_STAGES * w4_stage_bytes(MT);
}
static_assert(W4_KL * 16 * 2 * W4_BN * 4 <= W4_STAGES * w4_stage_bytes(1), "k-lane sums");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two offset-binary nibbles (bits 0-3 and 16-19 of v) as the bf16 pair
// (n0 - 8, n1 - 8): 0x4300 | n is the bf16 of 128 + n, and 128 + n - 136
// is exact. The high nibble of a byte is two's complement (hi & 15); xor 8
// makes it offset binary, so it rides the same subtraction.
__device__ __forceinline__ uint32_t nib_bf16(uint32_t v, uint32_t magic) {
  const uint32_t t = (v & 0x000F000Fu) ^ magic, k136 = 0x43084308u;  // bf16 (136, 136)
  const __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Grid (S splits, stacks x column tiles, row tiles), W4_THREADS threads;
// the S splits of a tile are one thread-block cluster (S > 1).
template <int MT>
__global__ void __launch_bounds__(W4_THREADS, MT == 1 ? 2 : 1)
w4a16_kernel(const __nv_bfloat16* __restrict__ x,  // [M, C] activations
             const int8_t* __restrict__ w,         // [stacks, C, Os] packed bytes
             const float* __restrict__ scale,      // [stacks, nG, Os] paired scales
             float* __restrict__ out,              // [M, stacks, 2, Os]
             int M, int C, int Os, int nG) {
  constexpr int XR = 16 * MT;  // activation rows of a block
  constexpr int STAGE = w4_stage_bytes(MT);
  constexpr int SLAB = W4_KC * W4_SLAB;  // bytes of a warp column's slab in a stage
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int kl = warp & (W4_KL - 1);  // this warp's 16-row step of every chunk
  const int sl = warp / W4_KL;        // its slab of 32 byte columns
  const int S = gridDim.x, split = blockIdx.x;
  const int tiles = (Os + W4_BN - 1) / W4_BN;
  const int stk = blockIdx.y / tiles;
  const int n_blk = (blockIdx.y % tiles) * W4_BN;
  const int m_blk = blockIdx.z * XR;
  const int gs = C / nG;  // rows of a scale group
  // Split s owns the groups [s * nG / S, (s + 1) * nG / S): whole groups,
  // ragged where S does not divide nG.
  const int r_lo = (split * nG / S) * gs, r_hi = ((split + 1) * nG / S) * gs;
  w += (long long)stk * C * Os;
  scale += (long long)stk * nG * Os;

  // Chunk c into stage st: every thread one 16-byte weight piece (row R of
  // the chunk, slab, half), the activation rows and the scale rows of the
  // groups the chunk touches (slot i: group c0 / gs + i).
  auto issue = [&](int c, int st) {
    const int c0 = r_lo + c * W4_KC;
    uint8_t* sB = smem + st * STAGE;
    {
      const int R = tid >> 2, s = (tid >> 1) & 1, h = tid & 1;
      const int col = n_blk + s * W4_SLAB + h * 16;
      const bool ok = c0 + R < r_hi && col < Os;
      // Rows in groups of four, the group's rows rotated by its index: the
      // four rows 4 apart that a quad of lanes reads land on 4 x 8 banks.
      const int phys = (R & ~3) | ((R + (R >> 2)) & 3);
      cp16(sB + s * SLAB + phys * W4_SLAB + h * 16,
           ok ? w + (long long)(c0 + R) * Os + col : w, ok);
    }
    for (int i = tid; i < XR * (W4_KC / 8); i += W4_THREADS) {
      const int r = i / (W4_KC / 8), k = (i % (W4_KC / 8)) * 8;
      const bool ok = m_blk + r < M && c0 + k < r_hi;
      cp16(sB + W4_KC * W4_BN + r * W4_XS + k * 2,
           ok ? x + (long long)(m_blk + r) * C + c0 + k : x, ok);
    }
    if (tid < W4_SLOTS * (W4_BN / 4)) {
      const int slot = tid / (W4_BN / 4), col = n_blk + (tid % (W4_BN / 4)) * 4;
      const int g = c0 / gs + slot;
      if (g * gs < min(c0 + W4_KC, r_hi) && col < Os)
        cp16(sB + W4_KC * W4_BN + XR * W4_XS + (slot * W4_BN + col - n_blk) * 4,
             scale + (long long)g * Os + col, true);
    }
  };

  // acc: the folded sums; gacc: the running group's dots. [m tile][nibble
  // half][column j of four][fragment]: tile j's column n is byte column
  // 4n + j of the slab.
  float acc[MT][2][4][4], gacc[MT][2][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][h][j][i] = gacc[mt][h][j][i] = 0.f;

  const int nch = (r_hi - r_lo + W4_KC - 1) / W4_KC;
  // The group of this warp's step and the first group of the chunk, with
  // the rows where each ends, advanced as the rows go (no division per step).
  int g = (r_lo + 16 * kl) / gs, g_end = (g + 1) * gs;
  int cg = r_lo / gs, cg_end = (cg + 1) * gs;
#pragma unroll
  for (int st = 0; st < W4_STAGES - 1; ++st) {
    if (st < nch) issue(st, st);
    cp_commit();  // one group per stage, empty or not, so the wait count holds
  }
  for (int c = 0; c < nch; ++c) {
    cp_wait<W4_STAGES - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();           // ... every thread's, and chunk c - 1 is consumed
    if (c + W4_STAGES - 1 < nch) issue(c + W4_STAGES - 1, (c + W4_STAGES - 1) % W4_STAGES);
    cp_commit();
    const int c0 = r_lo + c * W4_KC;
    const int row = c0 + 16 * kl;  // this warp's step: rows [row, row + 16)
    if (row >= r_hi) continue;
    for (; c0 >= cg_end; cg_end += gs) ++cg;
    for (; row >= g_end; g_end += gs) ++g;
    const uint8_t* sB = smem + (c % W4_STAGES) * STAGE;
    // The mma's k index is a permutation of the step's rows: lane quad tq
    // holds rows 4 tq .. 4 tq + 3 (k 2tq, 2tq + 1 | 2tq + 8, 2tq + 9), so
    // its four weight bytes of a column are four rows of the chunk and its
    // activations four neighbouring values of a row.
    uint32_t wr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wr[r] = ld32(sB + sl * SLAB + (16 * kl + 4 * tq + ((r + tq) & 3)) * W4_SLAB + 4 * gq);
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint8_t* xp = sB + W4_KC * W4_BN + (mt * 16 + gq) * W4_XS + (16 * kl + 4 * tq) * 2;
      const uint2 lo = *reinterpret_cast<const uint2*>(xp);
      const uint2 hi = *reinterpret_cast<const uint2*>(xp + 8 * W4_XS);
      a[mt][0] = lo.x, a[mt][2] = lo.y, a[mt][1] = hi.x, a[mt][3] = hi.y;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // Byte j of rows (0, 1) and of rows (2, 3) in the low bytes of two
      // 16-bit lanes: each byte's low nibble and, shifted, its high one.
      const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
      const uint32_t t01 = __byte_perm(wr[0], wr[1], sel), t23 = __byte_perm(wr[2], wr[3], sel);
      const uint32_t e0 = nib_bf16(t01, 0x43004300u), e1 = nib_bf16(t23, 0x43004300u);
      const uint32_t o0 = nib_bf16(t01 >> 4, 0x43084308u), o1 = nib_bf16(t23 >> 4, 0x43084308u);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(gacc[mt][0][j], a[mt], e0, e1);
        mma_bf16(gacc[mt][1][j], a[mt], o0, o1);
      }
    }
    // This warp's last step of the group: its dots times the group's scale
    // (paired: one per byte column, both halves) into the sums.
    if (row + W4_KC >= min(g_end, r_hi)) {
      const float* sS = reinterpret_cast<const float*>(sB + W4_KC * W4_BN + XR * W4_XS) +
                        (g - cg) * W4_BN + sl * W4_SLAB + 8 * tq;
      const float4 s0 = *reinterpret_cast<const float4*>(sS);      // columns 8tq + j
      const float4 s1 = *reinterpret_cast<const float4*>(sS + 4);  // columns 8tq + 4 + j
      const float sc0[4] = {s0.x, s0.y, s0.z, s0.w}, sc1[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[mt][h][j][i] = __fmaf_rn(gacc[mt][h][j][i], (i & 1) ? sc1[j] : sc0[j],
                                           acc[mt][h][j][i]);
              gacc[mt][h][j][i] = 0.f;
            }
    }
  }

  // The k-lanes' sums, added in k-lane order: red[kl][(r * 2 + h) * W4_BN + n].
  cp_wait<0>();
  __syncthreads();  // the ring is free
  constexpr int E = XR * 2 * W4_BN;  // a block's outputs
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = mt * 16 + gq + (i >> 1) * 8;
          const int n = sl * W4_SLAB + 8 * tq + 4 * (i & 1) + j;
          red[kl * E + (r * 2 + h) * W4_BN + n] = acc[mt][h][j][i];
        }
  __syncthreads();
  auto store = [&](int e, float v) {
    const int r = e / (2 * W4_BN), h = (e / W4_BN) & 1, n = e % W4_BN;
    if (m_blk + r < M && n_blk + n < Os)
      out[((long long)(m_blk + r) * (gridDim.y / tiles) + stk) * 2 * Os + h * Os + n_blk + n] = v;
  };
  for (int e = tid; e < E; e += W4_THREADS) {
    float v = red[e];
#pragma unroll
    for (int k = 1; k < W4_KL; ++k) v = __fadd_rn(v, red[k * E + e]);
    if (S == 1)
      store(e, v);
    else
      red[e] = v;
  }
  if (S == 1) return;
  // The splits' sums, added in split order: block s adds its share of the
  // tile's outputs from every block's shared memory (split s is cluster
  // rank s), then waits until every block has read its own.
  cluster_sync();
  const int lo = split * E / S, hi = (split + 1) * E / S;
  for (int e = lo + tid; e < hi; e += W4_THREADS) {
    float v = ld_cluster(cluster_addr(red + e, 0));
    for (int s = 1; s < S; ++s) v = __fadd_rn(v, ld_cluster(cluster_addr(red + e, s)));
    store(e, v);
  }
  cluster_sync();
}

template <int MT>
int launch_w4(const __nv_bfloat16* x, const int8_t* w, const float* scale, float* out, int M,
              int C, int Os, int nG, int stacks, int S, cudaStream_t st) {
  auto kernel = w4a16_kernel<MT>;
  static bool ready = false;  // one per instance
  const cudaError_t ready_e = allow_smem(kernel, ready);
  if (ready_e != cudaSuccess) return (int)ready_e;
  const dim3 grid(S, stacks * ((Os + W4_BN - 1) / W4_BN), (M + 16 * MT - 1) / (16 * MT));
  const cudaError_t e = launch_kernel(kernel, {grid, dim3(W4_THREADS), w4_smem_bytes(MT), st,
                                               false, S},
                                      x, w, scale, out, M, C, Os, nG);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Checks the shape and the splits shared by K6 and K7 and fills a.sp: whole
// fold spans on 32-row steps, in order, covering [0, C).
bool take_splits(Args& a, const int* rows) {
  if (a.M < 1 || a.M > 256 || a.C % 32 || a.nG < 1 || a.C % a.nG || (a.C / a.nG) % 8 ||
      a.F % 8 || a.F < 8 || a.C % a.F || a.S < 1 || a.S > MAX_SPLITS || !rows ||
      rows[0] != 0 || rows[a.S] != a.C)
    return false;
  for (int s = 0; s <= a.S; ++s) {
    if (rows[s] % 32 || rows[s] % a.F || (s > 0 && rows[s] <= rows[s - 1])) return false;
    a.sp.row[s] = rows[s];
  }
  return true;
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
  Args a{static_cast<const int8_t*>(x),
         static_cast<const float*>(xs),
         static_cast<const int8_t*>(w) + (long long)layer * C * Wn,
         static_cast<const float*>(scale) + (long long)layer * nG * Wn,
         out, M, C, Wn, nG, F, width, ldo, riffle, S, 1, {}, static_cast<float*>(ws),
         static_cast<int*>(counters)};
  if (!take_splits(a, rows) || (S > 1 && (!ws || !counters)) || Wn % BN || width < 1 ||
      ldo < width)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_fp32 ? launch_t<float>(a, st) : launch_t<__nv_bfloat16>(a, st);
}

// K7: int8 weights [Lf, C, Wn], output [M, Wn]. kw: k-warps on each
// column (1, or 2 where fold spans are whole 128-row runs); rows [S + 1]:
// the splits' contraction rows (ops/qmatmul.py plan_w8a8), whole chunks of
// 128 * kw rows, at most W8_MAX_SPLITS (a cluster).
extern "C" int qmm_w8a8(const void* x, const void* xs, const void* w, const void* scale,
                        void* out, int out_fp32, int M, int C, int Wn, int nG, int F, int layer,
                        int kw, const int* rows, int S, void* stream) {
  Args a{static_cast<const int8_t*>(x),
         static_cast<const float*>(xs),
         static_cast<const int8_t*>(w) + (long long)layer * C * Wn,
         static_cast<const float*>(scale) + (long long)layer * nG * Wn,
         out, M, C, Wn, nG, F, Wn, Wn, 0, S, kw, {}, nullptr, nullptr};
  if (S > W8_MAX_SPLITS || !take_splits(a, rows) || (kw != 1 && kw != 2) || Wn % W8_BN ||
      (kw == 2 && F % W8_RANGE) || (nG > 1 && F != C / nG))
    return (int)cudaErrorInvalidValue;
  for (int s = 1; s < S; ++s)  // splits are whole chunks
    if (rows[s] % (W8_RANGE * kw)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_fp32 ? launch_w8_t<float>(a, st) : launch_w8_t<__nv_bfloat16>(a, st);
}

// Dynamic shared memory of one block at MT row tiles, fold span F and nspan
// held spans (chip_smoke.py prints it beside each case): K6, and K7 at kw
// k-warps.
extern "C" int qmm_smem_bytes(int MT, int F, int nspan) {
  return smem_bytes(MT, kstep_of(F), nspan);
}

extern "C" int qmm_w8a8_smem_bytes(int MT, int F, int kw, int nspan) {
  return w8_smem_bytes(MT, kstep_of(F), kw, nspan);
}

// K9: packed int4 weights [stacks, C, Os] (byte = 16*hi + (lo + 8)) with
// paired fp32 scales [stacks, nG, Os] against bf16 activations x [M, C],
// M < 512, C / nG a multiple of 16 rows, Os a multiple of 16: out [M,
// stacks, 2, Os] fp32, the even (lo) and odd (hi) nibbles' products. S:
// the splits of the groups, one cluster per output tile (ops/qmatmul.py
// plan_w4a16).
extern "C" int qmm_w4a16(const void* x, const void* w, const void* scale, void* out, int M,
                         int C, int Os, int nG, int stacks, int S, void* stream) {
  if (M < 1 || M > 511 || nG < 1 || C % nG || (C / nG) % 16 || Os < 16 || Os % 16 ||
      stacks < 1 || S < 1 || S > W4_MAX_SPLITS || S > nG)
    return (int)cudaErrorInvalidValue;
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const int8_t*>(w);
  auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return M <= 16 ? launch_w4<1>(xp, wp, sp, op, M, C, Os, nG, stacks, S, st)
                 : launch_w4<2>(xp, wp, sp, op, M, C, Os, nG, stacks, S, st);
}

// Dynamic shared memory of one K9 block at MT row tiles of 16.
extern "C" int qmm_w4a16_smem_bytes(int MT) { return w4_smem_bytes(MT); }
