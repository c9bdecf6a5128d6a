// Device helpers shared by the weight-stationary scan kernels (lstm.cu,
// gcn_lstm.cu, ggru.cu) for Hopper, sm_90a: the TF32 rounding of their
// TF32 instantiations' operands, the one-shot bulk load of a
// weight slice into shared memory (cp.async.bulk on an mbarrier), the 16-byte
// cp.async prefetch of a frame's hoisted inputs, the release/acquire
// counter of a cooperative group, the st.async exchange between the CTAs
// of a cluster, and the k-slice reductions over the lanes of a warp.
//
// A header, not a library: ops/_build.py hashes every csrc/*.cuh into the
// name of each library it builds, so an edited helper rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

// Bytes at the head of dynamic shared memory: the mbarrier of the weight
// load and a few per-CTA integers; the float arrays start after it.
constexpr int kHeaderBytes = 64;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// fp32 x rounded to TF32 (10 mantissa bits), to nearest, ties to even; inf
// and NaN as they are, a finite value past the largest TF32 to inf: bit for
// bit a3gc_tpu_torch/ops/_common.py round_tf32 (and
// jax.lax.reduce_precision(x, 8, 10)). cvt.rna.tf32.f32 rounds ties away
// from zero, so it is not used. A product of two TF32 values is exact in
// fp32, so an FMA loop on rounded operands does one tensor-core pass's
// arithmetic up to the order of its sums.
__device__ __forceinline__ float tf32_round(float x) {
  const uint32_t i = __float_as_uint(x);
  if ((i & 0x7f800000u) == 0x7f800000u) return x;
  return __uint_as_float((i + 0x0fffu + ((i >> 13) & 1u)) & 0xffffe000u);
}

// x as a product operand of a kernel's TF32 (rounded) or fp32 (as it is)
// instantiation.
template <bool TF32>
__device__ __forceinline__ float operand(float x) {
  if constexpr (TF32) return tf32_round(x);
  return x;
}

template <bool TF32>
__device__ __forceinline__ float4 operand(float4 v) {
  return make_float4(operand<TF32>(v.x), operand<TF32>(v.y),
                     operand<TF32>(v.z), operand<TF32>(v.w));
}

// Round a [rows, cols] slice of shared memory, rows `stride` floats apart,
// in place (TF32 only), every thread of the block taking a share: a weight
// slice the TMA unit copied as it is. Once a launch.
template <bool TF32>
__device__ __forceinline__ void round_smem(float* p, int rows, int cols,
                                           int stride) {
  if constexpr (TF32)
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      float* q = p + (size_t)(e / cols) * stride + e % cols;
      *q = tf32_round(*q);
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier expecting one arrival (the thread that announces the bytes).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Global → shared through the TMA unit; `bytes` % 16 == 0, both addresses
// 16-byte aligned. Completes as transaction bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Phase clock, compiled in only with -DSCAN_PHASE_CLOCK (the card's
// machine has no profiler that sees inside a kernel): thread 0 of block
// (0, 0, 0) adds the SM cycles since its previous mark to slot i, so the
// slots split one CTA's critical path — barrier waits included — by phase.
// scripts/torch_kernel_phases.py builds and reads it; the shipped build
// compiles every mark to nothing.
constexpr int kPhaseSlots = 24;
#ifdef SCAN_PHASE_CLOCK
__device__ unsigned long long g_phase_cycles[kPhaseSlots];
__device__ __forceinline__ long long phase_now() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
struct PhaseClock {
  bool on;
  long long last;
  __device__ explicit PhaseClock(bool on_) : on(on_), last(phase_now()) {}
  __device__ void mark(int i) {
    if (!on) return;
    const long long t = phase_now();
    // a reduction without a return value: the thread does not wait for it
    atomicAdd(&g_phase_cycles[i], (unsigned long long)(t - last));
    last = phase_now();
  }
};
#define SCAN_PHASE_EXPORT(name)                                            \
  extern "C" int name##_phase_cycles(unsigned long long* out) {           \
    cudaError_t e = cudaMemcpyFromSymbol(out, scan::g_phase_cycles,       \
                                         sizeof(scan::g_phase_cycles));   \
    static const unsigned long long zero[scan::kPhaseSlots] = {};         \
    if (e == cudaSuccess)                                                  \
      e = cudaMemcpyToSymbol(scan::g_phase_cycles, zero, sizeof(zero));   \
    return (int)e;                                                         \
  }
#else
struct PhaseClock {
  __device__ explicit PhaseClock(bool) {}
  __device__ void mark(int) {}
};
#define SCAN_PHASE_EXPORT(name)
#endif

// Lanes of a warp hold one column each in groups of `cpw` = 32 / KS lanes,
// KS k-slices apart (lane = ks·cpw + column): sum the KS partial sums of
// every accumulator, leaving the total in all KS lanes. The butterfly adds
// each pair in both lanes the same way, so the totals agree bit for bit.
// Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ void reduce_k_slices(float (&acc)[N], int cpw) {
  for (int off = cpw; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
}

// The same sum, each total left in ONE lane: a lane keeps the half of its
// values that its k-slice's lowest bit chooses and sends the other half, so
// the shuffles halve at every step (SIZE - SIZE / KS in all, where
// reduce_k_slices needs SIZE · log2 KS). Afterwards v[0 … SIZE / KS) hold
// the totals of the accumulators first … first + SIZE / KS - 1, `first`
// returned. Call with SIZE = N, ks = the lane's k-slice, off = cpw; every
// lane of the warp must call it.
template <int N, int SIZE>
__device__ __forceinline__ int reduce_scatter_k_slices(float (&v)[N], int ks,
                                                       int off, int KS) {
  if constexpr (SIZE >= 2 && SIZE % 2 == 0) {
    if (KS > 1) {
      const bool up = ks & 1;
#pragma unroll
      for (int i = 0; i < SIZE / 2; ++i) {
        const float keep = up ? v[SIZE / 2 + i] : v[i];
        const float send = up ? v[i] : v[SIZE / 2 + i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      return (up ? SIZE / 2 : 0) + reduce_scatter_k_slices<N, SIZE / 2>(
                                       v, ks >> 1, off << 1, KS >> 1);
    }
  }
  return 0;
}

// Distributed-shared-memory exchange without cluster barriers: a producer
// writes into a peer's shared memory with st.async, each store completing
// its bytes on the peer's mbarrier; the peer announces the bytes it expects
// (mbar_arrive_expect_tx, one arrival) and waits on the phase. No fence is
// needed on either side (a cluster barrier's release costs a GPU-scope
// MEMBAR, which waits for every outstanding global store).
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_async(uint32_t dst, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t dst, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// Wait for a phase whose bytes came from other CTAs of the cluster.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

}  // namespace scan
