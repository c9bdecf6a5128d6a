// Device helpers shared by the weight-stationary scan kernels (lstm.cu,
// gcn_lstm.cu, ggru.cu) for Hopper, sm_90a: the TF32 rounding of their
// TF32 instantiations' operands and the tensor-core products of those
// instantiations (mma.sync m16n8k8 TF32: the instruction, the fragment
// loads, the staging of a weight slice as B, a warp's n-tiles, the 16-node
// graph mix), the one-shot bulk load of a
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

// ---------------------------------------------------------------------------
// Tensor-core products of the TF32 instantiations: mma.sync m16n8k8 with
// TF32 operands and fp32 accumulators (PTX ISA, "Warp-level matrix
// multiply-accumulate", m16n8k8 .tf32; CUTLASS
// cute::SM80_16x8x8_F32TF32TF32F32_TN spells out the same layouts). Lane
// (g, t) = (lane / 4, lane % 4) holds
//   A [16 × 8], row-major: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4);
//   B [8 × 8]:             b0 (t, g), b1 (t + 4, g);
//   D [16 × 8]:            d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
//                          d3 (g + 8, 2t + 1).
// The operands are fp32 registers holding TF32 values (tf32_round, ties to
// even): the tensor core reads their top 19 bits and would drop the low 13
// of an unrounded value (a truncation, not the JAX cell's rounding). A
// product of two TF32 values is exact in fp32, so a step adds 8 exact
// products into the fp32 accumulator: the FMA loop's arithmetic up to the
// order of its sums.
__device__ __forceinline__ void mma_tf32_16x8x8(float (&d)[4], float a0,
                                                float a1, float a2, float a3,
                                                float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// A 16-deep block of k as two m16n8k8 steps, k renumbered inside the block
// so that each lane's operands of a row are adjacent: lane (g, t) takes
// columns 4t … 4t + 3 of the block, 4t + 2s and 4t + 2s + 1 in step s (the
// step's k = t and t + 4). A row of A and a column of B are then one 16-byte
// load each: `a_lo` = A[g][4t … 4t + 3], `a_hi` = A[g + 8][4t … 4t + 3],
// `b` = B[4t … 4t + 3][g] (B stored transposed, column-major). Step 0 adds into
// `d`, step 1 into `e`: two independent accumulators, summed by the caller
// (mma_sum) once the k range is done.
__device__ __forceinline__ void mma_tf32_k16(float (&d)[4], float (&e)[4],
                                             float4 a_lo, float4 a_hi,
                                             float4 b) {
  mma_tf32_16x8x8(d, a_lo.x, a_hi.x, a_lo.y, a_hi.y, b.x, b.y);
  mma_tf32_16x8x8(e, a_lo.z, a_hi.z, a_lo.w, a_hi.w, b.z, b.w);
}

__device__ __forceinline__ void mma_zero(float (&d)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
}

// d += e, the two accumulators of mma_tf32_k16.
__device__ __forceinline__ void mma_sum(float (&d)[4], const float (&e)[4]) {
  d[0] += e[0];
  d[1] += e[1];
  d[2] += e[2];
  d[3] += e[3];
}

// Row stride (floats) of an A operand in shared memory: ≡ 16 (mod 32), so
// that the 16-byte loads of mma_tf32_k16 (a quarter-warp reads rows g and
// g + 1 at columns 4t) fall on 8 distinct 4-bank groups.
__host__ __device__ inline int mma_row_stride(int K) {
  return K + (48 - K % 32) % 32;
}

// Float offset of B[k][n] in a transposed [N][K] matrix of K % 32 == 0,
// swizzled instead of padded: the 16-byte chunk k / 4 of column n is stored
// at chunk (k / 4) ^ 4·(n & 1), so that the column loads of mma_tf32_k16 (a
// quarter-warp reads columns g and g + 1 at k = 4t) hit distinct banks.
__host__ __device__ inline int mma_b_offset(int n, int k, int K) {
  return n * K + ((((k >> 2) ^ ((n & 1) << 2)) << 2) | (k & 3));
}

// Stage a weight slice as B of the tensor-core products, once a launch:
// column n < N of `dst` (the mma_b_offset layout, K % 32 == 0) is column
// col(n) of the row-major [K, ld] matrix `src` in global memory (col maps 4
// adjacent n to 4 adjacent columns), rounded to TF32. 4 × 4 blocks are read
// as 4 rows of 16 bytes and written as 4 columns; the threads of a warp walk
// k, so that a quarter-warp's stores hit 8 distinct 16-byte chunks. Every
// thread of the block calls it.
template <class Col>
__device__ __forceinline__ void stage_b_tf32(float* dst, const float* src,
                                             int ld, int N, int K, Col col) {
  const int KC = K / 4;
  for (int e = threadIdx.x; e < (N / 4) * KC; e += blockDim.x) {
    const int nb = e / KC, kc = e - nb * KC;
    const float* p = src + (size_t)(4 * kc) * ld + col(4 * nb);
    float r[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + q * ld));
      r[q][0] = tf32_round(v.x);
      r[q][1] = tf32_round(v.y);
      r[q][2] = tf32_round(v.z);
      r[q][3] = tf32_round(v.w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dst + mma_b_offset(4 * nb + i, 4 * kc, K)) =
          make_float4(r[0][i], r[1][i], r[2][i], r[3][i]);
  }
}

// One warp's n-tiles of D = A·B on the tensor cores, over k ∈ [0, K): tile
// i < `count` (≤ TILES) at B's columns n0[i] … n0[i] + 7. A is row-major in
// shared memory (row stride `as`, mma_row_stride), its 16-byte loads passed
// through op(v, half) (half 0: row lane / 4, 1: row lane / 4 + 8), which
// returns TF32 values; B is staged by stage_b_tf32. The tiles share each A
// load and their accumulators are independent (two each: mma_tf32_k16).
// d[i] ends with lane (g, t)'s D fragment of tile i.
template <int TILES, class Op>
__device__ __forceinline__ void mma_tiles(float (&d)[TILES][4],
                                          const float* a, int as, Op op,
                                          const float* bt, int K,
                                          const int (&n0)[TILES], int count) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float e[TILES][4];
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    mma_zero(d[i]);
    mma_zero(e[i]);
  }
  const float* lo = a + g * as + 4 * t;
  const float* hi = lo + 8 * as;
  // column n of B at n·K + 4t, block k / 16 at 16·((k / 16) ^ (n & 1)): the
  // mma_b_offset swizzle of k = 16·block + 4t
  const float* bp[TILES];
  int par[TILES];
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    bp[i] = bt + (n0[i] + g) * K + 4 * t;
    par[i] = (n0[i] + g) & 1;
  }
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    const float4 x = op(*reinterpret_cast<const float4*>(lo + k), 0);
    const float4 y = op(*reinterpret_cast<const float4*>(hi + k), 1);
#pragma unroll
    for (int i = 0; i < TILES; ++i)
      if (i < count)
        mma_tf32_k16(d[i], e[i], x, y,
                     *reinterpret_cast<const float4*>(
                         bp[i] + 16 * ((k >> 4) ^ par[i])));
  }
#pragma unroll
  for (int i = 0; i < TILES; ++i) mma_sum(d[i], e[i]);
}

// Lane (g, t)'s D fragment of an n-tile into rows g, g + 8 and columns 2t,
// 2t + 1 of `dst` (row stride `ds`, at the tile's first column), rounded to
// TF32 when ROUND (an operand of the next product).
template <bool ROUND>
__device__ __forceinline__ void mma_store(float* dst, int ds,
                                          const float (&d)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    *reinterpret_cast<float2*>(dst + (g + 8 * r) * ds + 2 * t) =
        ROUND ? make_float2(tf32_round(d[2 * r]), tf32_round(d[2 * r + 1]))
              : make_float2(d[2 * r], d[2 * r + 1]);
}

// The A fragments of an adjacency held in registers for the whole launch
// (the graph mix, K = 16 nodes as two steps): am[4s + i] is step s's a_i of
// the n × n matrix `m` (row stride `ld`, TF32 values) padded with zeros to
// 16 × 16.
__device__ __forceinline__ void mma_a16_fragments(float (&am)[8],
                                                  const float* m, int ld,
                                                  int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1), col = 8 * s + t + 4 * (i >> 1);
      am[4 * s + i] = row < n && col < n ? m[row * ld + col] : 0.0f;
    }
}

// One n-tile of the graph mix D = adj·Z on the tensor cores: Z's tile (16
// node rows × 8 columns, TF32 values) in shared memory at `z` (row stride
// `zs`), A's fragments from mma_a16_fragments. Returns lane (g, t)'s D
// fragment in d.
__device__ __forceinline__ void mma_mix16(float (&d)[4], const float (&am)[8],
                                          const float* z, int zs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  mma_zero(d);
#pragma unroll
  for (int s = 0; s < 2; ++s)
    mma_tf32_16x8x8(d, am[4 * s], am[4 * s + 1], am[4 * s + 2], am[4 * s + 3],
                    z[(8 * s + t) * zs + g], z[(8 * s + t + 4) * zs + g]);
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
