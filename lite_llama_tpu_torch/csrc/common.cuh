// Helpers shared by the port's CUDA sources (csrc/*.cu), each included once
// per source: shared-memory barriers and TMA copies, the programmatic
// dependent launch, and the per-row int8 rounding of K6's activations.
//
// ops/_build.py hashes this header with every source that includes it, so
// an edited helper never runs from a stale build.

#pragma once

#include <cuda.h>  // CUtensorMap (its encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// The barrier counts an arrival of this thread when its cp.asyncs so far land.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > 20000000000LL) __trap();  // ~10 s: a lost arrival, not a wait
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// A 2D tile (column x, row y) of the tensor map into shared memory, its
// bytes counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Programmatic dependent launch (PDL)
//
// A kernel launched by launch_kernel with pdl set may start while the
// kernel before it in the stream still runs, once that kernel has called
// pdl_launch_dependents() in every block (or exited). It must call
// pdl_wait() before it reads anything its predecessor writes, and before it
// writes anything (its predecessor may still read it); pdl_wait() returns
// once the predecessor has completed and its writes are visible, at once
// when there is none. Every kernel launched so calls pdl_wait() in every
// block, so its own completion implies its predecessor's.

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Where and how a kernel is launched: with `pdl`, as a programmatic
// dependent of the kernel before it in the stream; with `cluster` > 1,
// in thread-block clusters of that many blocks along x.
struct Launch {
  dim3 grid, block;
  int smem;
  cudaStream_t stream;
  bool pdl;
  int cluster = 1;
};

template <typename... Params, typename... Values>
cudaError_t launch_kernel(void (*kernel)(Params...), const Launch& l, Values... args) {
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (l.pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (l.cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = l.cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n++].val.clusterDim.z = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = l.grid;
  cfg.blockDim = l.block;
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = l.stream;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---------------------------------------------------------------------------
// Thread-block clusters

// Shared-memory address of `p` in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// ---------------------------------------------------------------------------
// Per-row symmetric int8 activations, as ops/qmatmul.py _quantize_rows:
// xs = max(max|x|, 1e-30) * fp32(1/127) (XLA's product with the reciprocal
// of a constant divisor), xi = clamp(round-half-even(x / xs), -127, 127).
// K6's quantizer (csrc/qmatmul.cu quantize_rows_kernel) and the norms that
// emit K6's rows (csrc/norms.cu) both round through these two functions.

__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-30f), 1.0f / 127.0f);
}
__device__ __forceinline__ int quant_int8(float f, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(f, s)), -127.f), 127.f);
}

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

}  // namespace
