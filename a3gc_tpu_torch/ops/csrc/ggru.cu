// Bidirectional G-GRU scan for Hopper, sm_90a: a thread-block cluster per
// (stream, direction), weight-stationary.
//
// Replaces _ggru_kernel (a3gc_tpu/ops/pallas_gcn_lstm.py:412), which
// ggru_scan_pallas launches once per direction over B*15 rows, the B
// streams folded onto the rows with a block-diagonal adjacency per 128-row
// MXU tile, padded to 8 streams, and per-stream validity broadcast onto the
// rows through a membership matrix. None of that survives here: grid =
// (C, streams, 2 directions), both directions in one launch, and every
// cluster walks all T frames of its stream with the stream's 15 node rows
// as its own.
//
// The function, per frame (the JAX cell, fp32 FMA throughout, no bf16; the
// TF32 instantiation is below):
//   msg  = adj · (h·G)                      adj left-multiplies
//   zh   = msg · W_hid                      [N, 3H], gate order r, u, c
//   r = σ(zi_r + zh_r), u = σ(zi_u + zh_u)  zi = x·W_in + b_in, hoisted
//   cand = tanh(zi_c + r·zh_c)              r scales zh_c only
//   h'   = u·h + (1 − u)·cand
//   frame < n_valid[stream] ? h = h' : keep h
//   y[s, frame, :, d·H:(d+1)·H] = h          (no tanh on this cell)
// The backward direction walks frame = T-1 … 0 and reads zi in forward
// frame order, as the Pallas index map does.
//
// How the fp32 instantiation computes it: adj·(h·G)·W_hid =
// (adj·h)·(G·W_hid). W = G·W_hid
// [H, 3H] does not change over the window, and the graph mix is as
// column-local on h as on h·G, so a frame is ONE product on one resident
// matrix with one exchange:
//   ah  = adj · h          own columns, after the update; to every CTA
//   zh  = ah · W           own gate columns
//   the GRU update of own columns of h (kept here only: [16, Hc])
// The sums are taken in another order than the JAX cell's (h·G first, then
// W_hid); the kernel phases of chip_smoke.py and the card tests hold the
// result to the plain version, which keeps the cell's order, at 1e-5.
//
// What bounds it: 6·N·H² + 2·N²·H FLOP per frame, stream and direction,
// sequential over frames, on a matrix (768 KiB per direction at H = 256)
// that one SM can neither hold nor stream from L2 at the rate the FMAs
// need. The design:
//   * CTA c of a cluster owns hidden columns [c·Hc, (c+1)·Hc), Hc = H / C,
//     and forms the r, u, c columns of W of those units ([H, 3·Hc]) in
//     shared memory once per launch, from all of G and its columns of
//     W_hid read through L1 (a thread: 4 rows × the 12 gate columns of 4
//     units, 48 accumulators): H·H·3·Hc FMAs a CTA, at H = 256, C = 8
//     49k SM cycles for the FMAs alone and 107-128k measured on an H100,
//     against 60 frames of ≈ 10k;
//   * the product splits k over the lanes of a warp: a thread owns the 6
//     gate columns of a pair of units × one k-slice, with the 16 (padded)
//     node rows as its 96 accumulators. Shuffles sum the k-slices, each
//     total ending in one lane (a reduce-scatter), which stores it; the GRU
//     update and the graph mix then run one item a thread from shared
//     memory. What bounds the product is shared-memory bandwidth and the
//     FMA rate together (an x value loaded feeds 6 FMAs): ≈ 5.1k SM cycles
//     at H = 256, whose FMAs alone take 3.1k;
//   * one exchange a frame and no cluster barrier (its release is a
//     GPU-scope MEMBAR that waits for every outstanding global store): a
//     CTA's columns of adj·h go straight into every peer's shared memory
//     with st.async, each store completing its bytes on the receiver's
//     mbarrier. Nothing else orders the peers' frames, so the full adj·h is
//     double-buffered and the exchange alternates between two mbarriers
//     with the buffer: a peer can run at most one valid frame ahead (its
//     next adj·h needs this CTA's columns, which leave after this CTA's
//     product has read the current buffer), so its stores land in the
//     buffer this CTA is not reading and on the mbarrier this CTA is not
//     waiting on;
//   * the frame's zi slice is fetched by cp.async at the top of the frame
//     and waited for before the cell, behind the product;
//   * n_valid is per stream, so per cluster: a carried frame skips the
//     product and the exchange and only writes y.
// The TF32 instantiation (a net's precision="default" on the card) keeps
// the JAX cell's order, because TF32 rounds each product's operands and
// the fold would round other values (G·W_hid and adj·h, where the cell
// rounds h·G and msg): a CPU emulation of the folded order put it as far
// from the plain version at TF32 as the fp32 kernel is. Every operand is
// tf32_round of what the cell rounds (G and W_hid once a launch, when they
// are staged; h when it is exchanged; hg and msg when they are formed): the
// tensor core would truncate an unrounded fp32. What bounds its FMA form (a
// frame of two products and two exchanges) at H = 64 / 128
// was the second exchange and its barriers, not the arithmetic (1.93× /
// 1.49× the fp32 fold's time). On the tensor cores (mma.sync.m16n8k8 TF32,
// scan_common.cuh; plan field mma, wherever mma_ok allows):
//   * mma 2, where all of G fits beside the W_hid slice (H ≤ 128): every
//     CTA forms all of hg = round(h)·round(G) and msg = round(adj)·round(hg)
//     itself, from the full rounded h it already receives, so a frame has
//     ONE exchange, as the fp32 fold: h own columns to every CTA (the
//     carried exchange); hg and msg per n-tile of a warp (the mix a second
//     mma on the warp's own columns, behind a __syncwarp); zh = msg·W_hid on
//     own gate columns. Every CTA runs the same instructions on the same
//     operands, so the peers' msg agree bit for bit. The redundant products
//     are 256 (H = 128) and 64 (H = 64) mma a CTA a frame;
//   * mma 1 (H = 256: all of G is 256 KiB): the two exchanges stay, hg and
//     msg on own columns, msg pushed to every CTA by st.async per n-tile;
//   * G's and W_hid's slices sit transposed and swizzled for 16-byte B
//     loads, the rows of h and msg padded to a stride ≡ 16 (mod 32).
// The FMA form (plan mma = 0, a shape without a tensor-core plan):
//   h    rounded own columns to every CTA (the carried exchange)
//   hg   = h · G                own columns, [H, Hc] of G resident
//   msg  = adj · hg             column-local; rounded, to every CTA
//   zh   = msg · W_hid          own gate columns, [H, 3·Hc] of W_hid
//   the GRU update of own columns (h itself stays fp32)
// Both exchanges are double-buffered on their own pair of mbarriers, by the
// argument above: a peer's next stores into a buffer need a value this CTA
// sends only after it has read that buffer.
//
// The launch plan (C, k-slices, shared-memory bytes) comes from the Python
// wrapper (ops/ggru.py launch_plan); the C side recomputes the shared
// memory and refuses a plan that disagrees.
//
// Layouts (all contiguous fp32 unless noted):
//   zi [2, S, T, N, 3H]   G [2, H, H]   adj [2, N, N]   W_hid [2, H, 3H]
//   h0, h_out [2, S, N, H]   n_valid [S] int32   y [S, T, N, 2H]
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (a3gc_tpu_torch/ops/_build.py); bound to PyTorch
// with ctypes (a3gc_tpu_torch/ops/ggru.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace scan;

constexpr int kNodes = 16;       // node rows padded to 16; rows >= N stay zero
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

struct Args {
  const float* zi;
  const float* gk;
  const float* adj;
  const float* whid;
  const float* h0;
  const int* n_valid;
  float* y;
  float* h_out;
  int S, T, N, H, C, KS;
  unsigned divHc, divQ4, divM4;   // fast_div magics of Hc = H / C, Hc / 4
                                  // and 3·Hc / 4
};

// Floats between the 4-row groups of the gate matrix in shared memory: lanes
// of k-slices 4 rows apart then read banks 4 apart.
__host__ __device__ inline int gate_pad(int M) {
  return (36 - (4 * M) % 32) % 32;
}

// Floats of dynamic shared memory after the header. The TF32 instantiation
// adds G's own columns and the rounded h, double-buffered (its a_s holds
// msg, its zh_s h·G first). On the tensor cores (mma 1: G's own columns,
// mma 2: all of G) W_hid's and G's slices are transposed and swizzled
// (mma_b_offset), and the rows of h and msg padded to mma_row_stride; mma 2
// forms all of msg in every CTA, in one buffer.
size_t smem_floats(int N, int H, int C, bool tf32, int mma) {
  const size_t Hc = H / C, M = 3 * Hc;
  if (mma) {
    const size_t HS = mma_row_stride(H);
    return (size_t)H * M + (mma == 1 ? 2 : 1) * kNodes * HS +   // W^T, msg
           (size_t)N * M + (size_t)kNodes * M +                 // zi, zh
           kNodes * kNodes + (size_t)kNodes * Hc +              // adj, own h
           (mma == 2 ? (size_t)H : Hc) * H +                    // G^T
           2 * (size_t)kNodes * HS;                             // h, 2 buffers
  }
  return (size_t)H * M + (size_t)(H / 4) * gate_pad(M) +   // W slice
         2 * (size_t)kNodes * H +                          // adj·h, 2 buffers
         (size_t)N * M + (size_t)kNodes * M +              // zi, zh
         kNodes * kNodes + (size_t)kNodes * Hc +           // adj, own h
         (tf32 ? (size_t)H * Hc + (size_t)(H / 4) * gate_pad(Hc) +  // G
                     2 * (size_t)kNodes * H                // h, 2 buffers
               : 0);
}

// e / d for 0 <= e < 2^16 and 2 <= d <= 2^10 by one multiplication, magic =
// ⌈2^32 / d⌉ (the frame loops map a thread's work item to node and column;
// a hardware division costs tens of dependent instructions).
unsigned div_magic(int d) { return (unsigned)((0x100000000ull + d - 1) / d); }
__device__ __forceinline__ int fast_div(int e, unsigned magic) {
  return magic ? (int)__umulhi((unsigned)e, magic) : e;     // 0: d == 1
}

// This CTA's next phase of the exchange on `mb`: (C - 1) peers' `bytes`
// each. Every thread of the CTA calls it.
__device__ __forceinline__ void receive(uint64_t* mb, uint32_t parity, int C,
                                        int bytes) {
  if (threadIdx.x == 0)
    mbar_arrive_expect_tx(mb, (uint32_t)((C - 1) * bytes));
  mbar_wait_cluster(mb, parity);
}

// float4 `v` into own shared memory at `dst` and the same place in every
// peer's, counted on the peer's mbarrier `mb`.
__device__ __forceinline__ void publish(float* dst, float4 v, uint64_t* mb,
                                        int c, int C) {
  *reinterpret_cast<float4*>(dst) = v;
  for (int peer = 0; peer < C; ++peer)
    if (peer != c) st_async(map_rank(dst, peer), v, map_rank(mb, peer));
}

// cp.async of frame `frame`'s zi slice (own r, u, c columns of every node)
// of stream s into zi_s [N, 3·Hc]; one commit group.
__device__ __forceinline__ void fetch_zi_slice(const Args& a, float* zi_s,
                                               int frame, int s, int c,
                                               int d) {
  const int N = a.N, H = a.H, Hc = H / a.C, M4 = 3 * Hc / 4;
  for (int e = threadIdx.x; e < N * M4; e += kThreads) {
    const int n = fast_div(e, a.divM4), q = e - n * M4;
    const int g = fast_div(4 * q, a.divHc), j = 4 * q - g * Hc;
    cp_async16(zi_s + (size_t)e * 4,
               a.zi + ((((size_t)d * a.S + s) * a.T + frame) * N + n) * 3 * H +
                   g * H + c * Hc + j);
  }
  cp_async_commit();
}

// The terms m … m + 3 of fold_weights: 4 rows of G and the 12 gate columns
// of 4 rows of W_hid.
__device__ __forceinline__ void fold_load(float4 (&gq)[4], float4 (&wq)[12],
                                          const float* grow,
                                          const float* wcol, int H, int m) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    gq[i] = __ldg(reinterpret_cast<const float4*>(grow + (size_t)i * H + m));
#pragma unroll
  for (int mm = 0; mm < 4; ++mm)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      wq[3 * mm + g] = __ldg(reinterpret_cast<const float4*>(
          wcol + (size_t)(m + mm) * 3 * H + g * H));
}

// W[:, own gate columns] = G · W_hid[:, own gate columns] into w_s (row k at
// k·M + (k / 4)·P): a thread owns 4 rows × the r, u, c columns of 4 adjacent
// units and walks all H terms, G and W_hid read through L1 (the lanes of a
// warp share G's rows or read adjacent columns of W_hid), the next 4 terms
// loaded while the current ones are multiplied.
__device__ __forceinline__ void fold_weights(const Args& a, float* w_s,
                                             const float* gk,
                                             const float* whid, int c) {
  const int H = a.H, Hc = H / a.C, M = 3 * Hc, q4 = Hc / 4;
  const int P = gate_pad(M);
  for (int e = threadIdx.x; e < (H / 4) * q4; e += kThreads) {
    const int kb = fast_div(e, a.divQ4), q = e - kb * q4;
    const float* grow = gk + (size_t)4 * kb * H;
    const float* wcol = whid + c * Hc + 4 * q;
    float acc[4][12];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 12; ++t) acc[i][t] = 0.0f;
    float4 gq[4], wq[12];
    fold_load(gq, wq, grow, wcol, H, 0);
    for (int m = 0; m < H; m += 4) {
      float4 gn[4], wn[12];
      fold_load(gn, wn, grow, wcol, H, m + 4 < H ? m + 4 : m);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gx = mm == 0 ? gq[i].x : mm == 1 ? gq[i].y
                           : mm == 2 ? gq[i].z : gq[i].w;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float4 w = wq[3 * mm + g];
            acc[i][4 * g] = fmaf(gx, w.x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(gx, w.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(gx, w.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(gx, w.w, acc[i][4 * g + 3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) gq[i] = gn[i];
#pragma unroll
      for (int i = 0; i < 12; ++i) wq[i] = wn[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = w_s + (size_t)(4 * kb + i) * M + kb * P + 4 * q;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        *reinterpret_cast<float4*>(row + g * Hc) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
    }
  }
}

// The TF32 instantiation's weights, rounded, in the layout of the products:
// W_hid's own gate columns into w_s (row k at k·M + (k / 4)·gate_pad(M), as
// the fold's) and G's own columns into g_s (row k at k·Hc +
// (k / 4)·gate_pad(Hc)). Once a launch.
__device__ __forceinline__ void stage_weights_tf32(const Args& a, float* w_s,
                                                   float* g_s,
                                                   const float* gk,
                                                   const float* whid, int c) {
  const int H = a.H, Hc = H / a.C, M = 3 * Hc, M4 = M / 4, q4 = Hc / 4;
  const int P = gate_pad(M), GP = gate_pad(Hc);
  for (int e = threadIdx.x; e < H * M4; e += kThreads) {
    const int k = e / M4, col = 4 * (e - k * M4);
    const int g = col / Hc, j = col - g * Hc;
    *reinterpret_cast<float4*>(w_s + (size_t)k * M + (k >> 2) * P + col) =
        operand<true>(__ldg(reinterpret_cast<const float4*>(
            whid + (size_t)k * 3 * H + g * H + c * Hc + j)));
  }
  for (int e = threadIdx.x; e < H * q4; e += kThreads) {
    const int k = e / q4, col = 4 * (e - k * q4);
    *reinterpret_cast<float4*>(g_s + (size_t)k * Hc + (k >> 2) * GP + col) =
        operand<true>(__ldg(reinterpret_cast<const float4*>(
            gk + (size_t)k * H + c * Hc + col)));
  }
}

// One unit of the GRU update (the JAX cell's op order).
__device__ __forceinline__ float gru_unit(float h, float zir, float ziu,
                                          float zic, float zhr, float zhu,
                                          float zhc) {
  const float rg = sigmoid_f(zir + zhr);
  const float ug = sigmoid_f(ziu + zhu);
  const float cand = tanhf(zic + rg * zhc);
  return ug * h + (1.0f - ug) * cand;
}

// The product on a resident matrix of NG column groups Hc apart ([H, NG·Hc]
// in shared memory, row k at k·M + (k / 4)·P): a thread owns units u, u + 1
// of each group (2·NG columns) and one k-slice, with the 16 node rows as
// its 2·NG·16 accumulators acc[2·NG·n + 2g + j] (node n, group g, unit
// u + j). NG = 3 is the gate product (the r, u and c columns of two units,
// 6 columns: Hc / 2 column groups, a power of two with the k-slices, so
// every lane of every warp works, where 4 columns leave a quarter of them
// idle, and an x value loaded feeds 6 FMAs instead of 4); NG = 1 is the TF32
// instantiation's h·G.
constexpr int kGateAcc = 6 * kNodes;

template <int NG>
__device__ __forceinline__ void gate_product(float (&acc)[2 * NG * kNodes],
                                             const float* x, const float* w,
                                             int H, int Hc, int M, int P,
                                             int k0, int KS4) {
  for (int k = k0; k < H; k += KS4) {
    const float* wr = w + (size_t)k * M + (k >> 2) * P;
    float2 wv[4][NG];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        wv[q][g] = *reinterpret_cast<const float2*>(wr + q * M + g * Hc);
#pragma unroll
    for (int n = 0; n < kNodes; ++n) {
      const float4 xv = *reinterpret_cast<const float4*>(x + n * H + k);
      const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[2 * NG * n + 2 * g] =
              fmaf(xk[q], wv[q][g].x, acc[2 * NG * n + 2 * g]);
          acc[2 * NG * n + 2 * g + 1] =
              fmaf(xk[q], wv[q][g].y, acc[2 * NG * n + 2 * g + 1]);
        }
    }
  }
}

// Sum the gate accumulators over the k-slices of a warp and store the totals
// to out[n, g·Hc + j] (rows M apart, `out` at the thread's unit u): the lane
// of k-slice ks ends with 96 / KS of them, whole node rows (at KS = 32 half
// a row). Every lane calls it; `own` is false past the last column group.
__device__ __forceinline__ void store_gate_totals(float (&acc)[kGateAcc],
                                                  int ks, int cpw, int KS,
                                                  bool own, float* out,
                                                  int Hc, int M) {
  const int first =
      reduce_scatter_k_slices<kGateAcc, kGateAcc>(acc, ks, cpw, KS);
  if (!own) return;
  const int n0 = first / 6;
  float* o = out + n0 * M;
  if (KS == 32) {
    const int c0 = first - 6 * n0;             // 0 or 3
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int c6 = c0 + t;
      o[(c6 >> 1) * Hc + (c6 & 1)] = acc[t];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kNodes; ++i) {
    if (i * KS < kNodes) {
#pragma unroll
      for (int g = 0; g < 3; ++g)
        *reinterpret_cast<float2*>(o + i * M + g * Hc) =
            make_float2(acc[6 * i + 2 * g], acc[6 * i + 2 * g + 1]);
    }
  }
}

// The same for NG = 1: the lane of k-slice ks ends with 32 / KS totals,
// whole pairs of one node row (at KS = 32 one value), stored to
// out[n, j] (rows M apart).
__device__ __forceinline__ void store_pair_totals(float (&acc)[2 * kNodes],
                                                  int ks, int cpw, int KS,
                                                  bool own, float* out,
                                                  int M) {
  const int first =
      reduce_scatter_k_slices<2 * kNodes, 2 * kNodes>(acc, ks, cpw, KS);
  if (!own) return;
  if (KS == 32) {
    out[(first >> 1) * M + (first & 1)] = acc[0];
    return;
  }
  float* o = out + (first >> 1) * M;
#pragma unroll
  for (int i = 0; i < kNodes; ++i)
    if (i * KS < kNodes)
      *reinterpret_cast<float2*>(o + i * M) =
          make_float2(acc[2 * i], acc[2 * i + 1]);
}

// dst[:, own columns] = adj · src (src: this CTA's columns [16, Hc]), or src
// itself when `mix` is false, to every CTA's buffer `dst` (row n at
// n·stride, own columns at c·Hc), counted on the receivers' mbarrier `mb`:
// the mix is within a column, one (node, 4 columns) a thread. At TF32 the
// operands and the result are rounded.
template <bool TF32>
__device__ __forceinline__ void publish_columns(const Args& a,
                                                const float* adj_s,
                                                const float* src, float* dst,
                                                uint64_t* mb, int c, bool mix,
                                                int stride) {
  const int N = a.N, H = a.H, Hc = H / a.C, q4 = Hc / 4;
  for (int e = threadIdx.x; e < N * q4; e += kThreads) {
    const int n = fast_div(e, a.divQ4), col = 4 * (e - n * q4);
    const float* sc = src + col;
    float4 v = {0.0f, 0.0f, 0.0f, 0.0f};
    if (mix) {
      const float* arow = adj_s + n * kNodes;
#pragma unroll
      for (int m = 0; m < kNodes; ++m) {
        const float am = arow[m];             // zero past N
        const float4 g =
            operand<TF32>(*reinterpret_cast<const float4*>(sc + m * Hc));
        v.x = fmaf(am, g.x, v.x);
        v.y = fmaf(am, g.y, v.y);
        v.z = fmaf(am, g.z, v.z);
        v.w = fmaf(am, g.w, v.w);
      }
    } else {
      v = *reinterpret_cast<const float4*>(sc + n * Hc);
    }
    publish(dst + (size_t)n * stride + c * Hc + col, operand<TF32>(v), mb, c,
            a.C);
  }
}

template <bool TF32, int MMA>
__global__ void __launch_bounds__(kThreads, 1) ggru_kernel(Args a) {
  static_assert(TF32 || !MMA, "the tensor cores take TF32 operands");
  cg::cluster_group cluster = cg::this_cluster();
  PhaseClock clk(threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
                 blockIdx.z == 0);
  const int c = blockIdx.x;      // cluster rank (cluster dims (C, 1, 1))
  const int s = blockIdx.y;
  const int d = blockIdx.z;
  const int S = a.S, T = a.T, N = a.N, H = a.H, C = a.C;
  const int Hc = H / C, M = 3 * Hc, WP = gate_pad(M), GP = gate_pad(Hc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = a.n_valid[s];
  // row stride of the full h and of msg (padded for the tensor cores'
  // fragment loads)
  const int HS = MMA ? mma_row_stride(H) : H;
  const int gq = lane >> 2, tq = lane & 3;   // an mma fragment's (g, t)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [2] the peers' columns of adj·h (fp32) or msg (TF32), one mbarrier a
  // buffer; [2] at TF32 the peers' columns of h
  uint64_t* mb_a = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* mb_x = mb_a + 2;
  // [H, M] (padded, gate_pad); with MMA W_hid^T [M, H] (mma_b_offset)
  float* w_s = reinterpret_cast<float*>(smem_raw + kHeaderBytes);
  // [2, 16, HS] adj·h | msg (MMA 2: one buffer)
  float* a_s = w_s + (MMA ? (size_t)M * H : (size_t)H * M + (H / 4) * WP);
  float* zi_s = a_s + (MMA == 2 ? 1 : 2) * (size_t)kNodes * HS;  // [N, M]
  float* zh_s = zi_s + (size_t)N * M;          // [16, M] ah·W | h·G, msg·W
  float* adj_s = zh_s + (size_t)kNodes * M;    // [16, 16], zero padded
  float* h_s = adj_s + kNodes * kNodes;        // [16, Hc] own columns of h
  // TF32: [H, Hc] of G; MMA 1: G^T [Hc, H], MMA 2: G^T [H, H]
  float* g_s = h_s + (size_t)kNodes * Hc;
  float* x_s = g_s + (MMA == 2 ? (size_t)H * H : (size_t)H * Hc +
                                     (MMA ? 0 : (H / 4) * GP));  // [2, 16, HS]
  const size_t buf = (size_t)kNodes * HS;
  // the carried exchange: adj·h (fp32) or h (TF32)
  float* carry_s = TF32 ? x_s : a_s;
  uint64_t* mb_c = TF32 ? mb_x : mb_a;

  if (tid == 0) {
    mbar_init(mb_a);
    mbar_init(mb_a + 1);
    if constexpr (TF32) {
      mbar_init(mb_x);
      mbar_init(mb_x + 1);
    }
  }

  // thread mapping of the products: a pair of units × one k-slice, lane =
  // k-slice · (32 / slices) + pair
  const int cpwW = 32 / a.KS, KS4W = 4 * a.KS;
  const int wwarps = (Hc / 2 + cpwW - 1) / cpwW;
  const int ksW = lane / cpwW, cpW = warp * cpwW + lane % cpwW;
  const int colW = 2 * (cpW < Hc / 2 ? cpW : Hc / 2 - 1);    // the unit pair

  for (int e = tid; e < kNodes * kNodes; e += kThreads) {
    const int n = e / kNodes, m = e - n * kNodes;
    adj_s[e] = (n < N && m < N)
                   ? operand<TF32>(a.adj[(size_t)d * N * N + n * N + m])
                   : 0.0f;
  }
  // h0: own columns into h_s, all columns into the second buffer of the
  // carried exchange; at fp32 the first then gets adj·h0 (each thread mixes
  // whole columns), at TF32 the rounded h0 is the first frame's operand and
  // the other buffers' padded rows are zeroed
  const float* h0 = a.h0 + ((size_t)d * S + s) * N * H;
  for (int e = tid; e < kNodes * Hc; e += kThreads) {
    const int n = fast_div(e, a.divHc), j = e - n * Hc;
    h_s[e] = n < N ? h0[(size_t)n * H + c * Hc + j] : 0.0f;
  }
  for (int e = tid; e < kNodes * HS; e += kThreads) {
    const int n = e / HS, k = e - n * HS;
    carry_s[buf + e] = n < N && k < H ? operand<TF32>(h0[n * H + k]) : 0.0f;
    if constexpr (TF32) {
      a_s[e] = x_s[e] = 0.0f;
      if constexpr (MMA != 2) a_s[buf + e] = 0.0f;
    }
  }
  __syncthreads();
  // MMA: the A fragments of the graph mix, round(adj) padded, for the window
  float adjf[MMA ? 8 : 1];
  if constexpr (MMA) {
    mma_a16_fragments(adjf, adj_s, kNodes, kNodes);
    const float* gk = a.gk + (size_t)d * H * H;
    stage_b_tf32(w_s, a.whid + (size_t)d * H * 3 * H, 3 * H, M, H,
                 [=](int n) { return (n / Hc) * H + c * Hc + n % Hc; });
    stage_b_tf32(g_s, gk, H, MMA == 2 ? H : Hc, H,
                 [=](int n) { return MMA == 2 ? n : c * Hc + n; });
  } else if constexpr (TF32) {
    stage_weights_tf32(a, w_s, g_s, a.gk + (size_t)d * H * H,
                       a.whid + (size_t)d * H * 3 * H, c);
  } else {
    for (int k = tid; k < H; k += kThreads) {
      const float* src = a_s + buf + k;
      float col[kNodes];
#pragma unroll
      for (int m = 0; m < kNodes; ++m) col[m] = src[m * H];
#pragma unroll
      for (int n = 0; n < kNodes; ++n) {
        float v = 0.0f;
#pragma unroll
        for (int m = 0; m < kNodes; ++m)
          v = fmaf(adj_s[n * kNodes + m], col[m], v);
        a_s[n * H + k] = v;                     // rows >= N: 0
      }
    }
    clk.mark(16);
    fold_weights(a, w_s, a.gk + (size_t)d * H * H,
                 a.whid + (size_t)d * H * 3 * H, c);
  }
  __syncthreads();
  clk.mark(21);
  cluster.sync();                // every peer is running and initialised

  const int slice_bytes = (int)sizeof(float) * N * Hc;
  uint32_t parity = 0;   // bit b: the phase of mb_c[b] to wait for next
  int cur = TF32 ? 1 : 0;  // the buffer of carry_s holding the carried h
  bool due = false;      // the peers' columns of buffer `cur` are in flight
  uint32_t parity_m = 0; // TF32: bit b, the phase of mb_a[b] to wait for next
  int cur_m = 0;         // TF32: the buffer of a_s that takes msg next
  for (int step = 0; step < T; ++step) {
    const int frame = d == 0 ? step : T - 1 - step;
    const bool valid = frame < nv;

    if (due) {                   // the peers' columns of the last frame
      receive(mb_c + cur, (parity >> cur) & 1, C, slice_bytes);
      parity ^= 1u << cur;
      due = false;
    }
    __syncthreads();             // own columns written, zi_s and zh_s free
    clk.mark(6);

    if (valid) {
      fetch_zi_slice(a, zi_s, frame, s, c, d);
      if constexpr (MMA) {
        // on the tensor cores: hg = h·G (MMA 2: every column, MMA 1: own
        // columns), then msg = round(adj)·round(hg) per n-tile, rounded,
        // into msg (MMA 1: own columns, sent to every CTA; then the peers')
        float* msg = a_s + (MMA == 1 ? cur_m * buf : 0);
        const int NG = (MMA == 2 ? H : Hc) / 8, mc = MMA == 2 ? 0 : c * Hc;
        for (int nt = warp; nt < NG; nt += 2 * kWarps) {
          const int n0[2] = {8 * nt, 8 * (nt + kWarps)};
          const int cnt = nt + kWarps < NG ? 2 : 1;
          float d4[2][4];
          mma_tiles(d4, carry_s + cur * buf, HS,
                    [](float4 v, int) { return v; }, g_s, H, n0, cnt);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < cnt) mma_store<true>(msg + mc + n0[i], HS, d4[i]);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < cnt) mma_mix16(d4[i], adjf, msg + mc + n0[i], HS);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < cnt) mma_store<true>(msg + mc + n0[i], HS, d4[i]);
          if constexpr (MMA == 1) {
            __syncwarp();
            const int n = lane >> 1;             // 16 rows × 2 float4 a tile
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (i >= cnt || n >= N) continue;
              float* src = msg + n * HS + mc + n0[i] + 4 * (lane & 1);
              const float4 v = *reinterpret_cast<const float4*>(src);
              for (int peer = 0; peer < C; ++peer)
                if (peer != c)
                  st_async(map_rank(src, peer), v,
                           map_rank(mb_a + cur_m, peer));
            }
          }
        }
        clk.mark(10);
        if constexpr (MMA == 1) {
          receive(mb_a + cur_m, (parity_m >> cur_m) & 1, C, slice_bytes);
          parity_m ^= 1u << cur_m;
        }
        __syncthreads();         // every column of msg
        clk.mark(12);
        // zh = msg·W_hid on own gate columns
        for (int nt = warp; nt < M / 8; nt += 2 * kWarps) {
          const int n0[2] = {8 * nt, 8 * (nt + kWarps)};
          const int cnt = nt + kWarps < M / 8 ? 2 : 1;
          float d4[2][4];
          mma_tiles(d4, msg, HS, [](float4 v, int) { return v; }, w_s, H, n0,
                    cnt);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < cnt) mma_store<false>(zh_s + n0[i], M, d4[i]);
        }
        clk.mark(3);
        if constexpr (MMA == 1) cur_m ^= 1;
      } else if constexpr (TF32) {
        // hg = h · G on own columns, into zh_s [16, Hc]; msg = adj · hg to
        // every CTA; then the peers' columns of msg
        if (warp < wwarps) {
          float acc[2 * kNodes];
#pragma unroll
          for (int n = 0; n < 2 * kNodes; ++n) acc[n] = 0.0f;
          gate_product<1>(acc, carry_s + cur * buf, g_s + colW, H, Hc, Hc,
                          GP, 4 * ksW, KS4W);
          store_pair_totals(acc, ksW, cpwW, a.KS, cpW < Hc / 2, zh_s + colW,
                            Hc);
        }
        clk.mark(10);
        __syncthreads();         // own columns of hg
        publish_columns<true>(a, adj_s, zh_s, a_s + cur_m * buf,
                              mb_a + cur_m, c, true, H);
        clk.mark(11);
        receive(mb_a + cur_m, (parity_m >> cur_m) & 1, C, slice_bytes);
        parity_m ^= 1u << cur_m;
        __syncthreads();         // own columns of msg written, hg read
        clk.mark(12);
      }
      // zh = ah · W (fp32) or msg · W_hid (TF32) on own gate columns
      if (MMA == 0 && warp < wwarps) {
        float acc[kGateAcc];
#pragma unroll
        for (int n = 0; n < kGateAcc; ++n) acc[n] = 0.0f;
        gate_product<3>(acc, TF32 ? a_s + cur_m * buf : a_s + cur * buf,
                        w_s + colW, H, Hc, M, WP, 4 * ksW, KS4W);
        clk.mark(3);
        store_gate_totals(acc, ksW, cpwW, a.KS, cpW < Hc / 2, zh_s + colW, Hc,
                          M);
        clk.mark(9);
      }
      if constexpr (TF32 && !MMA) cur_m ^= 1;
    }
    cp_async_wait_all();
    __syncthreads();             // zh_s and zi_s hold this frame
    clk.mark(4);

    // the GRU update of own columns, one unit a thread; the lanes of 4
    // adjacent units gather them for one 16-byte store to y. A carried
    // frame writes its h
    const int units = N * Hc;
    for (int base = 0; base < units; base += kThreads) {
      const bool live = base + tid < units;
      const int e = live ? base + tid : units - 1;
      const int n = fast_div(e, a.divHc), j = e - n * Hc;
      float h = h_s[e];
      if (valid) {
        const float* zi = zi_s + (size_t)n * M + j;
        const float* zh = zh_s + (size_t)n * M + j;
        h = gru_unit(h, zi[0], zi[Hc], zi[2 * Hc], zh[0], zh[Hc], zh[2 * Hc]);
        if (live) h_s[e] = h;
      }
      const float4 v = {h, __shfl_down_sync(0xffffffffu, h, 1),
                        __shfl_down_sync(0xffffffffu, h, 2),
                        __shfl_down_sync(0xffffffffu, h, 3)};
      if (live && (lane & 3) == 0)
        *reinterpret_cast<float4*>(
            a.y + (((size_t)s * T + frame) * N + n) * 2 * H + (size_t)d * H +
            c * Hc + j) = v;
    }
    clk.mark(valid ? 5 : 7);
    if (!valid) continue;
    __syncthreads();             // own columns of h updated
    // adj·h (fp32) or the rounded h (TF32) on own columns, to every CTA's
    // other buffer
    publish_columns<TF32>(a, adj_s, h_s, carry_s + (cur ^ 1) * buf,
                          mb_c + (cur ^ 1), c, !TF32, HS);
    cur ^= 1;
    due = true;
    clk.mark(1);
  }

  if (due) receive(mb_c + cur, (parity >> cur) & 1, C, slice_bytes);
  __syncthreads();
  for (int e = tid; e < N * Hc; e += kThreads) {
    const int n = fast_div(e, a.divHc), j = e - n * Hc;
    a.h_out[(((size_t)d * S + s) * N + n) * H + c * Hc + j] = h_s[e];
  }
  cluster.sync();                // no CTA leaves while its stores travel
  clk.mark(17);
}

struct Plan {
  int C, KS, threads, smem, mma;
};

bool pow2_upto32(int x) { return x > 0 && x <= 32 && (x & (x - 1)) == 0; }

// Shapes the tensor-core paths take: k in 16-deep blocks and swizzled
// weights (H % 32 == 0), whole n-tiles of own columns (Hc % 8 == 0).
bool mma_ok(int H, int Hc) { return H % 32 == 0 && Hc % 8 == 0; }

bool plan_ok(int N, int H, const Plan& pl, bool tf32) {
  if (N <= 0 || N > kNodes || H <= 0 || H % 4 != 0) return false;
  if (pl.C <= 0 || pl.C > kMaxCluster || H % pl.C != 0) return false;
  if (pl.threads != kThreads) return false;
  const int Hc = H / pl.C;
  if (Hc % 4 != 0) return false;
  if (!pow2_upto32(pl.KS) || H % (4 * pl.KS) != 0 ||
      Hc / 2 * pl.KS > kThreads)
    return false;
  if (pl.mma < 0 || pl.mma > 2 || (pl.mma && (!tf32 || !mma_ok(H, Hc))))
    return false;
  return (size_t)pl.smem ==
         kHeaderBytes + sizeof(float) * smem_floats(N, H, pl.C, tf32, pl.mma);
}

// Launches the scan (a != null) or asks how many clusters of the plan the
// card holds at once (a == null: the count, or minus a cudaError_t).
template <bool TF32, int MMA>
int launch(const Args* a, const Plan& pl, int S, cudaStream_t stream) {
  auto kern = ggru_kernel<TF32, MMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return a ? (int)err : -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.C, S, 2);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!a) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    return err == cudaSuccess ? clusters : -(int)err;
  }
  err = cudaLaunchKernelEx(&cfg, kern, *a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch(const Args* a, const Plan& pl, int S, bool tf32,
           cudaStream_t stream) {
  if (!tf32) return launch<false, 0>(a, pl, S, stream);
  return pl.mma == 2   ? launch<true, 2>(a, pl, S, stream)
         : pl.mma == 1 ? launch<true, 1>(a, pl, S, stream)
                       : launch<true, 0>(a, pl, S, stream);
}

template <bool TF32, int MMA>
cudaError_t attributes(cudaFuncAttributes* fa) {
  return cudaFuncGetAttributes(fa, ggru_kernel<TF32, MMA>);
}

}  // namespace

extern "C" {

// Most clusters of a plan of the fp32 (tf32 = 0) or the TF32 instantiation
// the card holds at once (cudaOccupancyMaxActiveClusters); a negative value
// is minus a cudaError_t.
int ggru_max_active(int S, int N, int H, int C, int KS, int threads,
                    int smem, int mma, int tf32) {
  const Plan pl{C, KS, threads, smem, mma};
  if (S <= 0 || !plan_ok(N, H, pl, tf32 != 0))
    return -(int)cudaErrorInvalidValue;
  return launch(nullptr, pl, S, tf32 != 0, nullptr);
}

// Registers a thread and local-memory bytes (spills) of the instantiation
// a launch of (tf32, mma) runs, from cudaFuncGetAttributes; returns a
// cudaError_t.
int ggru_func_attributes(int tf32, int mma, int* regs, int* local_bytes) {
  cudaFuncAttributes fa = {};
  if (mma < 0 || mma > 2 || (mma && !tf32)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = !tf32      ? attributes<false, 0>(&fa)
                        : mma == 2 ? attributes<true, 2>(&fa)
                        : mma == 1 ? attributes<true, 1>(&fa)
                                   : attributes<true, 0>(&fa);
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)e;
}

// Launches the scan on `stream`, the TF32 instantiation when tf32 != 0;
// returns cudaGetLastError() (0 on success).
int ggru_forward(const float* zi, const float* gk, const float* adj,
                 const float* whid, const float* h0, const int* n_valid,
                 float* y, float* h_out, int S, int T, int N, int H, int C,
                 int KS, int threads, int smem, int mma, int tf32,
                 cudaStream_t stream) {
  const Plan pl{C, KS, threads, smem, mma};
  if (S <= 0 || T <= 0 || !plan_ok(N, H, pl, tf32 != 0))
    return (int)cudaErrorInvalidValue;
  const int Hc = H / C;
  Args a{zi, gk, adj, whid, h0, n_valid, y, h_out, S, T, N, H, C, KS,
         div_magic(Hc), div_magic(Hc / 4), div_magic(3 * Hc / 4)};
  return launch(&a, pl, S, tf32 != 0, stream);
}

const char* ggru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

SCAN_PHASE_EXPORT(ggru)
