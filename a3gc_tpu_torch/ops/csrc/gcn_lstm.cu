// Bidirectional graph-LSTM scan (AAGC / A3GC / AGC cells) for Hopper, sm_90a:
// a thread-block cluster per (stream, direction), weight-stationary.
//
// Replaces the two TPU kernels of a3gc_tpu/ops/pallas_gcn_lstm.py that the
// serving path runs:
//   * _kernel          (:92,  launched by gcn_lstm_scan_pallas, one
//                       direction over R = B*15 rows, B streams folded);
//   * _dirfused_kernel (:705, launched by bi_gcn_lstm_pallas_dirfused,
//                       batch 1, both directions fused onto 2N rows).
// One launch here serves both contracts: grid = (C, S streams, 2
// directions), one cluster of C CTAs per (stream, direction), each cluster
// walking all T frames. The TPU row folding (block-diagonal adjacency per
// 128-row MXU tile, the padding to 8 streams, the segment matrices of the
// attention sums, the direction-row augmentation that saved Mosaic compile
// time) has no purpose here: a cluster owns exactly one stream's 15 nodes.
//
// Per frame, in order (the JAX cell's op order, fp32 FMA throughout, no bf16;
// the TF32 instantiation, on the tensor cores, is below):
//   z   = u_t + h·W_h                         u hoisted by the caller
//   pre = adj[g]·z_g + bias[g]                bias AFTER the graph mix
//   i,f,o = σ(pre), g = tanh(pre); c' = f·c + i·g; hy = o·tanh(c')
//   attention (A3GC/AGC): q = relu(Σ_nodes hy·W), s = tanh(hy·Wh + q·Wq + bs),
//                         (q computed as relu(Σ_c (Σ_nodes hy_c)·W_c), the
//                         same sum: rank c's hidden units, its rows of W)
//                         a = s·u + bu, hy += hy·σ(a)
//   frame < n_valid[stream] ? (h, c) = (hy, c') : keep (h, c)
//   y[s, frame, :, d·H:(d+1)·H] = tanh(h)
// The carried h is the post-attention hy, c the pre-attention c'. The
// backward direction walks frame = T-1 … 0 and reads u in forward frame
// order, as the Pallas index map does.
//
// What bounds it: ~12·N·H² FLOP per frame, stream and direction (8·N·H² for
// h·W_h, 4·N·H² for the attention products), sequential over frames, on
// weights (W_h alone 1 MiB per direction at H = 256) that one SM can neither
// hold nor stream from L2 at the rate the FMAs need. The design:
//   * CTA c of a cluster owns hidden units [c·Hc, (c+1)·Hc), Hc = H / C: the
//     four gate columns of each ([H, 4·Hc] of W_h, loaded once by
//     cp.async.bulk) and the Hc columns of Wq (each row rotated, see
//     wq_rotation) sit in shared memory; its Hc rows of the attention W and
//     Hc columns of Wh sit in registers (32 + 32 per thread, with
//     everything else 255 registers: the budget that bounds this design);
//   * everything up to the cell is local: the z slice for all 16 (padded)
//     node rows (thread = one column × one k-slice, shuffles sum the
//     k-slices), the 15×15 mix of each gate (it mixes rows within a
//     column, so a thread mixes its own column), the bias, the gates, c';
//   * attention, two exchanges a frame and no cluster barrier: each CTA
//     writes (1) its hy slice and its partial q, p_c = (Σ_nodes hy_c)·W_c
//     over all H columns (hy_c its own columns, W_c its own rows), and (2)
//     its partial s·u straight into every peer's shared memory with
//     st.async, each store completing its bytes on the receiver's mbarrier
//     (mb_h, mb_a), and waits only on its own mbarriers. (A cluster
//     barrier's release is a GPU-scope MEMBAR that waits for every
//     outstanding global store: ~1-2k cycles a barrier on the H100.)
//     Order: the hy slice, sent; its node sum (each warp sums the own
//     columns itself, lane k column k, into a row of scratch of its own:
//     no block barrier) and p_c, sent; the wait for the peers' (mb_h); q =
//     round(relu(Σ_r p_r)), summed in rank order, so every CTA holds the
//     same bits; own columns of hy·Wh; q·Wq and s; the partial s·u, sent
//     and waited for only in the next frame, after its h·W_h: h = hy +
//     hy·σ(a) scales whole node rows, so the product runs on hy and its
//     rows are scaled once every CTA has summed σ(a) from the same partials
//     in the same order (the previous frame's y is written then). No frame
//     updates the full h, and no CTA sums the nodes of all of h. One
//     mbarrier phase per frame cannot mix two frames' bytes: a peer pushes
//     its frame-t+1 hy and p into this CTA only after its wait for every
//     frame-t partial s·u, this CTA's included, which this CTA sends only
//     after it has consumed its frame-t p's (q) and hy slices (hy·Wh); and a
//     peer's frame-t+1 s·u follows its frame-t+1 mb_h wait, which needs this
//     CTA's frame-t+1 hy, sent only after this CTA consumed the frame-t
//     s·u's. So the partials need one buffer, a slot a rank (the own slot
//     holds this CTA's partial, then q). Without attention
//     the hy slice is the new h, exchanged by DSMEM stores and one cluster
//     barrier a frame. The full h (or hy) is double-buffered against the
//     peers' stores;
//   * the next frame's u slice is prefetched by cp.async during the cell
//     and the attention; masked frames of a stream (uniform over its
//     cluster) only write y.
// The TF32 instantiation (a net's precision="default" on the card, as XLA's
// Precision.DEFAULT here) multiplies operands rounded to TF32 where the JAX
// cell's products take them and sums in fp32. Its operands stay
// tf32_round (ties to even, bit for bit the plain version's round_tf32):
// the tensor core would truncate an unrounded fp32, and cvt.rna rounds ties
// away from zero. Weights are rounded once, where they are staged,
// activations where they are formed: z before the mix, q once summed,
// s before its partial s·u is sent, hy as the attention products read it,
// h = hy + hy·σ(a) by a pass before h·W_h. What bounds its FMA form (phase
// clocks, scripts/torch_kernel_phases.py --tf32 --fma, H = 256, with the
// scalar pass the float4 one below replaced): shared-memory reads of h·W_h
// (8k SM cycles a frame), hy·Wh rounding hy on every read in 255 registers
// with a spill (15k), and the pass that scaled and rounded h in place behind
// a barrier (5k). The tensor-core path (plan field mma = 1, wherever mma_ok
// allows: every serving width):
//   * h·W_h, 16 node rows × 4·Hc gate columns, on mma.sync.m16n8k8 TF32
//     (scan_common.cuh mma_tiles): warp w owns n-tiles of 8 gate columns
//     (2 at 4·Hc = 128, 1 at 64) over the whole k range, so no partial sums
//     cross warps and the mix needs no block barrier; W_h's slice sits in
//     shared memory transposed and swizzled for 16-byte B loads, h's rows
//     are padded to a stride ≡ 16 (mod 32) for 16-byte A loads. The A
//     operand round(h), h = hy + hy·σ(a), is formed once a CTA by a float4
//     pass in place that also writes the previous frame's y (shared with the
//     FMA form): scaling and rounding every warp's A
//     fragments as they were loaded instead cost 9.7k SM cycles a frame at
//     H = 256, more than the FMA loop. σ(a) is still waited for first: JAX
//     rounds the scaled h;
//   * z = round(u + h·W_h) is staged in the warp's own columns of pre_s and
//     the gate mix round(adj[g])·z_g runs as a second mma (K = 16 nodes,
//     two steps; adj's fragments in registers), a warp's n-tiles lying in
//     one gate (Hc % 8 == 0): a __syncwarp, not a barrier;
//   * round(hy)·Wh on the tensor cores, B fragments of Wh's own columns in
//     registers for the window (at most 8 k-blocks a warp: att_split k
//     parts of a warp each, their partial sums added in order with q·Wq);
//   * the three vector products ((Σ hy)·W, q·Wq, s·u) stay FMA loops, the
//     two st.async exchanges stay as they are.
// A shape without a tensor-core plan keeps the FMA form (plan mma = 0).
//
// The launch plan (C, k-slices, shared-memory bytes) comes from the Python
// wrapper (ops/gcn_lstm.py launch_plan); the C side recomputes the shared
// memory and refuses a plan that disagrees. Clusters are portable (C ≤ 8)
// except on the tensor-core path, which may take C = 16 (non-portable,
// opted into at launch): one stream's grid of 2 clusters leaves most SMs
// idle, so the plan at S = 1 spreads a (stream, direction) over twice the
// CTAs where mma_ok still holds, halving each CTA's products and W_h slice
// (the sums run over more k parts and peers, in a fixed order).
//
// Layouts (all contiguous fp32 unless noted):
//   u [2, S, T, N, 4H]   W_h [2, H, 4H]   adj [2, 4, N, N]   bias [2, 4, H]
//   attention w, wq, wh [2, H, H]; u, bs [2, H]; bu [2, N] (null when off)
//   h0, c0, h_out, c_out [2, S, N, H]   n_valid [S] int32   y [S, T, N, 2H]
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (a3gc_tpu_torch/ops/_build.py); bound to PyTorch
// with ctypes (a3gc_tpu_torch/ops/gcn_lstm.py).

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
constexpr int kMaxCluster = 8;       // portable cluster size
constexpr int kMaxClusterWide = 16;  // non-portable: tensor-core plans only
constexpr int kMaxKw = 32;       // attention W weights per thread (registers):
                                 // 1 column × the Hc own rows
constexpr int kMaxKca = 32;      // attention Wh weights per thread
                                 // (registers): 2 columns × H / KSA rows

struct Args {
  const float* u;
  const float* wh;
  const float* adj;
  const float* bias;
  const float* att_w;
  const float* att_wq;
  const float* att_wh;
  const float* att_u;
  const float* att_bs;
  const float* att_bu;
  const float* h0;
  const float* c0;
  const int* n_valid;
  float* y;
  float* h_out;
  float* c_out;
  int S, T, N, H, C, KS, KSA, KSQ;
};

// Wq's column slice [H, Hc] sits unpadded, row j rotated by wq_rotation:
// column k at (k + rot) % Hc. In q·Wq the lanes of k-slice ks (32 / KSQ
// adjacent columns) read rows j ≡ ks (mod KSQ); rows share a 32-bank line
// R = 32 / Hc at a time (Hc < 32), so the rotation moves the slices that
// share a line onto distinct banks.
__host__ __device__ inline int wq_rotation(int j, int Hc, int KSQ) {
  const int R = Hc < 32 ? 32 / Hc : 1;
  return 32 / KSQ * ((j % KSQ) / R) % Hc;
}

// The tensor-core path's hy·Wh: n-tiles Hc / 8 of own columns, each over
// `att_split` k parts of one warp each (at most 4: the partial sums' planes
// share pre_s), so that every warp holds at most 8 k-blocks of Wh's B
// fragments in registers.
__host__ __device__ inline int att_split(int H, int Hc) {
  int ks = 8 / (Hc / 8) < 4 ? 8 / (Hc / 8) : 4;
  while (ks > 1 && (H / 16) % ks != 0) ks /= 2;
  return ks;
}

// Floats of dynamic shared memory after the header. W_h's rows are padded
// by 4 floats: lanes of k-slices 4 rows apart then read different banks.
// The tensor-core path (mma) holds W_h's slice transposed and swizzled
// (mma_b_offset), pads the rows of the full h to mma_row_stride and those of
// the mixed gates by 8 floats (the mix reads B at bank 8t + g). Attention
// adds Wq's slice, the ranks' partial q (a slot of kThreads floats each: H
// ≤ kThreads, and the slots' loads take immediate offsets; this CTA's own
// slot then holds q) and the small vectors; hy·Wh and s take the mixed
// gates' buffer, free after the cell.
size_t smem_floats(int N, int H, int C, bool att, bool mma) {
  const size_t Hc = H / C, M = 4 * Hc;
  const size_t HS = mma ? mma_row_stride(H) : H, MP = mma ? M + 8 : M;
  size_t f = (mma ? (size_t)H * M : (size_t)H * (M + 4)) +
             2 * (size_t)kNodes * HS + kNodes * MP + N * M + N * Hc + M +
             4 * (size_t)N * N;
  if (att) f += (size_t)H * Hc + (size_t)C * kThreads + 2 * Hc +
                C * kNodes + 2 * kNodes;
  return f;
}

template <bool ATT, bool TF32, bool MMA>
__global__ void __launch_bounds__(kThreads, 1) gcn_lstm_kernel(Args a) {
  static_assert(TF32 || !MMA, "the tensor cores take TF32 operands");
  cg::cluster_group cluster = cg::this_cluster();
  PhaseClock clk(threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
                 blockIdx.z == 0);
  const int c = blockIdx.x;      // cluster rank (cluster dims (C, 1, 1))
  const int s = blockIdx.y;
  const int d = blockIdx.z;
  const int S = a.S, T = a.T, N = a.N, H = a.H, C = a.C, G = 4 * H;
  const int Hc = H / C, M = 4 * Hc, WS = M + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row strides of the full h and of the mixed gates (padded for the tensor
  // cores' fragment loads)
  const int HS = MMA ? mma_row_stride(H) : H, MP = MMA ? M + 8 : M;
  const int gq = lane >> 2, tq = lane & 3;   // an mma fragment's (g, t)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // the weights
  uint64_t* mb_h = bar + 1;      // this frame's hy slices and partial q
  uint64_t* mb_a = bar + 2;      // the peers' partial s·u
  // [H, WS]; with MMA W_h^T [M, H] (mma_b_offset)
  float* w_s = reinterpret_cast<float*>(smem_raw + kHeaderBytes);
  float* wq_s = w_s + (MMA ? (size_t)M * H : (size_t)H * WS);  // [H, Hc]
  float* hb = wq_s + (ATT ? (size_t)H * Hc : 0);   // [2, 16, HS] full h / hy
  // [16, MP] mixed gates; with attention, once the cell has read them, the
  // KSP partial planes [16, Hc] of hy·Wh, plane 0 then s
  float* pre_s = hb + 2 * kNodes * HS;
  float* u_s = pre_s + kNodes * MP;            // [N, M] this frame's u
  float* c_s = u_s + N * M;                    // [N, Hc] carried c slice
  float* bias_s = c_s + N * Hc;                // [M]
  float* adj_s = bias_s + M;                   // [4, N, N]
  float* pq_s = adj_s + 4 * N * N;             // [C, kThreads] partial q
  float* q_s = pq_s + c * kThreads;            // [H] own slot: p_c, then q
  float* bs_s = pq_s + (size_t)C * kThreads;   // [Hc]
  float* au_s = bs_s + Hc;                     // [Hc]
  float* apart_s = au_s + Hc;                  // [C, 16] partial s·u
  float* sg_s = apart_s + C * kNodes;          // [16] σ(a) of the carried h
  float* bu_s = sg_s + kNodes;                 // [16]

  // the W_h slice (column block g·H + c·Hc … of every row)
  const uint32_t wbytes = MMA ? 0 : sizeof(float) * H * M;
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(mb_h);
    mbar_init(mb_a);
    if (wbytes) mbar_arrive_expect_tx(bar, wbytes);
  }
  __syncthreads();
  const float* wh = a.wh + (size_t)d * H * G;
  if constexpr (MMA) {
    // transposed and rounded for the tensor cores: own gate column n =
    // g·Hc + j is column g·H + c·Hc + j of W_h
    stage_b_tf32(w_s, wh, G, M, H, [=](int n) {
      return (n / Hc) * H + c * Hc + n % Hc;
    });
  } else {
    for (int e = tid; e < 4 * H; e += kThreads) {
      const int k = e >> 2, g = e & 3;
      bulk_load(w_s + (size_t)k * WS + g * Hc,
                wh + (size_t)k * G + g * H + c * Hc, sizeof(float) * Hc, bar);
    }
  }
  if constexpr (ATT) {
    // Wq's own columns, rounded, row j rotated (wq_rotation)
    const float* awq = a.att_wq + (size_t)d * H * H + c * Hc;
    for (int e = tid; e < H * Hc; e += kThreads) {
      const int j = e / Hc, k = e - j * Hc;
      wq_s[j * Hc + (k + wq_rotation(j, Hc, a.KSQ)) % Hc] =
          operand<TF32>(__ldg(awq + (size_t)j * H + k));
    }
  }

  // thread mappings: in h·W_h a thread owns 4 adjacent columns (each h
  // float4 it loads feeds all 4: shared memory delivers 128 B a clock to
  // the registers, and that, not the FMAs, bounds these products), in hy·Wh
  // a pair; and one k-slice; lane = k-slice · (32 / slices) + column
  // group. k-slice ks takes the float4 groups k = 4·ks, 4·ks + 4·slices, …
  // (interleaved, so that the slices read different banks)
  const int cpw = 32 / a.KS, KS4 = 4 * a.KS;
  const int zwarps = (M / 4 + cpw - 1) / cpw;
  const int ks = lane / cpw, cp = warp * cpw + lane % cpw;
  const int col = 4 * (cp < M / 4 ? cp : M / 4 - 1);
  const int cpwA = 32 / a.KSA, KcA = H / a.KSA;
  const int awarps = (Hc / 2 + cpwA - 1) / cpwA;
  const int ksA = lane / cpwA, cpA = warp * cpwA + lane % cpwA;
  const int colA = 2 * (cpA < Hc / 2 ? cpA : Hc / 2 - 1);   // of Wh
  // q·Wq: a thread owns one column and k-slice ksQ, its rows j ≡ ksQ (mod
  // KSQ) at the column's rotated place
  const int cpwQ = 32 / a.KSQ;
  const int qwarps = (Hc + cpwQ - 1) / cpwQ;
  const int ksQ = lane / cpwQ, colQ = warp * cpwQ + lane % cpwQ;
  const int cq = colQ < Hc ? colQ : Hc - 1;
  const int cqr = (cq + wq_rotation(ksQ, Hc, a.KSQ)) % Hc;
  // (Σ_nodes hy_c)·W_c: thread j owns column j of all H over the own rows
  const int jw = tid < H ? tid : H - 1;

  // the tensor-core path's hy·Wh: warp w takes n-tile ta = w % NTA of own
  // columns over k part pa = w / NTA, KBP 16-deep k-blocks (warps past
  // NTA·KSP idle)
  const int NTA = MMA ? Hc / 8 : 1, KSP = MMA ? att_split(H, Hc) : 1;
  const int KBP = H / 16 / KSP, ta = warp % NTA, pa = warp / NTA;

  // registers for the whole window: this thread's column of the own rows
  // of the attention W (ww[i]: row c·Hc + i), and its column pair of
  // Wh at k-slice ksA (wa[2i + j]: column colA + j, the slice's i-th row),
  // or with MMA its B fragments of Wh (wb[i]: k-block pa·KBP + i of n-tile
  // ta, rounded) and the A fragments of its n-tiles' gate mix (adjf)
  float ww[ATT ? kMaxKw : 1], wa[ATT && !MMA ? kMaxKca : 1];
  float4 wb[ATT && MMA ? kMaxKca / 4 : 1];
  float adjf[MMA ? 8 : 1];
  if constexpr (ATT) {
    const float* aw = a.att_w + ((size_t)d * H + c * Hc) * H + jw;
#pragma unroll
    for (int i = 0; i < kMaxKw; ++i)
      ww[i] = i < Hc ? operand<TF32>(__ldg(aw + (size_t)i * H)) : 0.0f;
  }
  if constexpr (ATT && MMA) {
    const float* awh = a.att_wh + (size_t)d * H * H + c * Hc + 8 * ta + gq;
#pragma unroll
    for (int i = 0; i < kMaxKca / 4; ++i) {
      float4 v = {0.0f, 0.0f, 0.0f, 0.0f};
      if (i < KBP && pa < KSP) {
        const size_t k = 16 * (pa * KBP + i) + 4 * tq;
        v = make_float4(__ldg(awh + k * H), __ldg(awh + (k + 1) * H),
                        __ldg(awh + (k + 2) * H), __ldg(awh + (k + 3) * H));
      }
      wb[i] = operand<true>(v);
    }
  }
  if constexpr (ATT && !MMA) {
    const float* awh = a.att_wh + (size_t)d * H * H + c * Hc + colA;
#pragma unroll
    for (int i = 0; i < kMaxKca / 2; ++i) {
      const size_t row = 4 * ksA + a.KSA * (i & ~3) + (i & 3);
      wa[2 * i] = i < KcA ? operand<TF32>(__ldg(awh + row * H)) : 0.0f;
      wa[2 * i + 1] =
          i < KcA ? operand<TF32>(__ldg(awh + row * H + 1)) : 0.0f;
    }
  }

  const size_t st = ((size_t)d * S + s) * N * H;
  const int nv = a.n_valid[s];
  for (int e = tid; e < 2 * kNodes * HS; e += kThreads) {
    const int n = e / HS, k = e - n * HS;    // n ≥ 16: the second buffer
    hb[e] = n < N && k < H ? a.h0[st + (size_t)n * H + k] : 0.0f;
  }
  for (int e = tid; e < N * Hc; e += kThreads) {
    const int n = e / Hc;
    c_s[e] = a.c0[st + (size_t)n * H + c * Hc + (e - n * Hc)];
  }
  for (int e = tid; e < M; e += kThreads) {
    const int g = e / Hc;
    bias_s[e] = a.bias[((size_t)d * 4 + g) * H + c * Hc + (e - g * Hc)];
  }
  for (int e = tid; e < 4 * N * N; e += kThreads)
    adj_s[e] = operand<TF32>(a.adj[(size_t)d * 4 * N * N + e]);
  // MMA: warp w's n-tiles of the gate columns, w·NTW … (w + 1)·NTW - 1, lie
  // in one gate (plan: Hc % (8·NTW) == 0)
  const int NTW = M / 64;
  if constexpr (MMA) {
    __syncthreads();
    mma_a16_fragments(adjf, adj_s + (warp * NTW * 8 / Hc) * N * N, N, N);
  }
  if constexpr (ATT) {
    for (int e = tid; e < Hc; e += kThreads) {
      bs_s[e] = a.att_bs[(size_t)d * H + c * Hc + e];
      au_s[e] = operand<TF32>(a.att_u[(size_t)d * H + c * Hc + e]);
    }
    if (tid < kNodes) {
      bu_s[tid] = tid < N ? a.att_bu[(size_t)d * N + tid] : 0.0f;
      sg_s[tid] = 0.0f;          // h0 carries no attention: h = h0 + h0·0
    }
  }

  const float* u_seq = a.u + ((size_t)d * S + s) * T * N * G;
  auto prefetch_u = [&](int step) {
    const int frame = d == 0 ? step : T - 1 - step;
    const float* ut = u_seq + (size_t)frame * N * G;
    for (int e = tid; e < N * (M / 4); e += kThreads) {
      const int n = e / (M / 4), q = e - n * (M / 4);
      const int g = (4 * q) / Hc, j = 4 * q - g * Hc;
      cp_async16(u_s + n * M + 4 * q, ut + (size_t)n * G + g * H + c * Hc + j);
    }
    cp_async_commit();
  };
  // y = tanh(h) of `frame` on own columns; with attention h = hy + hy·σ(a)
  // row-wise
  float* y_sd = a.y + (size_t)s * T * N * 2 * H + (size_t)d * H + c * Hc;
  auto write_y = [&](int frame, const float* hy) {
    float* y_f = y_sd + (size_t)frame * N * 2 * H;
    for (int e = tid; e < N * Hc; e += kThreads) {
      const int n = e / Hc, j = e - n * Hc;
      float h = hy[n * HS + c * Hc + j];
      if constexpr (ATT) h = h + h * sg_s[n];
      y_f[(size_t)n * 2 * H + j] = tanhf(h);
    }
  };
  // this CTA's next phase of an exchange: (C - 1) peers' `bytes` each
  uint32_t ph_h = 0, ph_a = 0;
  auto receive = [&](uint64_t* mb, uint32_t& phase, int bytes) {
    if (tid == 0) mbar_arrive_expect_tx(mb, (uint32_t)((C - 1) * bytes));
    mbar_wait_cluster(mb, phase);
    phase ^= 1;
  };
  // every peer's partial s·u of the previous frame; σ(a) of each node,
  // summed in rank order, for the whole CTA
  auto resolve_gate = [&]() {
    receive(mb_a, ph_a, (int)sizeof(float) * N);
    if (tid < kNodes) {
      float v = 0.0f;
      for (int r = 0; r < C; ++r) v += apart_s[r * kNodes + tid];
      sg_s[tid] = tid < N ? sigmoid_f(v + bu_s[tid]) : 0.0f;
    }
    __syncthreads();
  };
  prefetch_u(0);
  if (wbytes) mbar_wait(bar, 0);
  if constexpr (!MMA) round_smem<TF32>(w_s, H, M, WS);
  cluster.sync();                // every peer is running and initialised
  clk.mark(16);

  int cur = 0;
  int yf = -1;       // attention: the frame whose σ(a) is still in flight
  for (int step = 0; step < T; ++step) {
    const int frame = d == 0 ? step : T - 1 - step;
    cp_async_wait_all();
    __syncthreads();             // u_s holds this frame's slice
    clk.mark(0);
    float* h_cur = hb + cur * kNodes * HS;
    float* h_nxt = hb + (cur ^ 1) * kNodes * HS;
    float* y_t = y_sd + (size_t)frame * N * 2 * H;

    if (frame >= nv) {           // the stream carries its state: y = tanh(h)
      if constexpr (ATT) {
        if (yf >= 0) {
          resolve_gate();
          write_y(yf, h_cur);
          yf = -1;
        }
      }
      if (step + 1 < T) prefetch_u(step + 1);
      write_y(frame, h_cur);
      clk.mark(1);
      continue;
    }

    if constexpr (TF32) {
      // the product's operand round(h), h = hy + hy·σ(a), in place, once a
      // CTA (JAX rounds the scaled h, so σ(a) of the previous frame is
      // waited for first; rounding in every warp's A fragments instead cost
      // more than the product); the previous frame's y from h. No valid
      // frame follows a masked one, so masked frames, y and h_out read a
      // buffer this has not rounded.
      if (ATT && yf >= 0) resolve_gate();
      clk.mark(22);
      // float4 chunk (n, q) of h, e = n·(H/4) + q stepping by the block
      const int c4 = H / 4, dn = kThreads / c4, dq = kThreads - dn * c4;
      for (int n = tid / c4, q = tid % c4; n < N;
           n += dn + (q + dq >= c4), q = q + dq >= c4 ? q + dq - c4 : q + dq) {
        const int k = 4 * q;
        float4* p = reinterpret_cast<float4*>(h_cur + n * HS + k);
        float4 h = *p;
        if constexpr (ATT) {
          const float sg = sg_s[n];
          h = make_float4(h.x + h.x * sg, h.y + h.y * sg, h.z + h.z * sg,
                          h.w + h.w * sg);
          if (yf >= 0 && k >= c * Hc && k < (c + 1) * Hc) {
            // one tanh live at a time: the FMA form has no register to spare
            float* yp = y_sd + ((size_t)yf * N + n) * 2 * H + (k - c * Hc);
            yp[0] = tanhf(h.x);
            yp[1] = tanhf(h.y);
            yp[2] = tanhf(h.z);
            yp[3] = tanhf(h.w);
          }
        }
        *p = operand<true>(h);
      }
      yf = -1;
      __syncthreads();
      clk.mark(23);
    }

    const bool gate_due = ATT && yf >= 0;
    if constexpr (MMA) {
      // z = u_t + round(h)·W_h on the tensor cores. Warp w owns n-tiles
      // w·NTW … over the whole k range: no partial sums to combine across
      // warps, and the mix below needs whole columns of z in the warp that
      // formed them.
      const int n0[2] = {warp * NTW * 8, warp * NTW * 8 + 8};
      float z[2][4];
      mma_tiles(z, h_cur, HS, [](float4 v, int) { return v; }, w_s, H, n0,
                NTW);
      clk.mark(2);
      // z = round(u + h·W_h), zero past the nodes, staged in this warp's
      // columns of pre_s as B of the mix
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= NTW) continue;
        const int col = n0[i] + 2 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = gq + 8 * r;
          float2 v = {0.0f, 0.0f};
          if (n < N) {
            const float2 uv =
                *reinterpret_cast<const float2*>(u_s + n * M + col);
            v = make_float2(tf32_round(uv.x + z[i][2 * r]),
                            tf32_round(uv.y + z[i][2 * r + 1]));
          }
          *reinterpret_cast<float2*>(pre_s + n * MP + col) = v;
        }
      }
      __syncwarp();
      clk.mark(20);
      // pre = round(adj[gate])·z_gate + bias, the mix on the tensor cores
      // (K = 16 nodes; one gate a warp); the staged z is read before any
      // lane overwrites it with pre
      float mix[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < NTW) mma_mix16(mix[i], adjf, pre_s + n0[i], MP);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= NTW) continue;
        const int col = n0[i] + 2 * tq;
        const float2 bv = *reinterpret_cast<const float2*>(bias_s + col);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(pre_s + (gq + 8 * r) * MP + col) =
              make_float2(mix[i][2 * r] + bv.x, mix[i][2 * r + 1] + bv.y);
      }
    } else {
      // z = u_t + h·W_h on own columns, all node rows (with attention, fp32:
      // h·W_h = (hy + hy·σ(a))·W_h, the product on hy, its rows scaled once
      // σ(a) is here); then the graph mix
      float acc[4 * kNodes];       // acc[4n + j]: node n, column col + j
      if (warp < zwarps) {
#pragma unroll
        for (int n = 0; n < 4 * kNodes; ++n) acc[n] = 0.0f;
        const float* wp = w_s + col;
        for (int k = 4 * ks; k < H; k += KS4) {
          float4 w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w[q] = *reinterpret_cast<const float4*>(wp + (k + q) * WS);
#pragma unroll
          for (int n = 0; n < kNodes; ++n) {
            const float4 hv =
                *reinterpret_cast<const float4*>(h_cur + n * H + k);
            const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[4 * n] = fmaf(hk[q], w[q].x, acc[4 * n]);
              acc[4 * n + 1] = fmaf(hk[q], w[q].y, acc[4 * n + 1]);
              acc[4 * n + 2] = fmaf(hk[q], w[q].z, acc[4 * n + 2]);
              acc[4 * n + 3] = fmaf(hk[q], w[q].w, acc[4 * n + 3]);
            }
          }
        }
        reduce_k_slices(acc, cpw);
      }
      clk.mark(2);
      if (gate_due) resolve_gate();
      clk.mark(3);
      if (warp < zwarps) {
        if (cp < M / 4) {
          const int g = col / Hc;  // all 4 columns: Hc % 4 == 0
#pragma unroll
          for (int m = 0; m < kNodes; ++m) {
            if (m < N) {
              if constexpr (ATT && !TF32) {
                const float sg = sg_s[m];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  acc[4 * m + j] = acc[4 * m + j] + acc[4 * m + j] * sg;
              }
              const float4 uv =
                  *reinterpret_cast<const float4*>(u_s + m * M + col);
              acc[4 * m] = operand<TF32>(uv.x + acc[4 * m]);
              acc[4 * m + 1] = operand<TF32>(uv.y + acc[4 * m + 1]);
              acc[4 * m + 2] = operand<TF32>(uv.z + acc[4 * m + 2]);
              acc[4 * m + 3] = operand<TF32>(uv.w + acc[4 * m + 3]);
            }
          }
          clk.mark(20);
          const float4 bv = *reinterpret_cast<const float4*>(bias_s + col);
          for (int n = ks; n < N; n += a.KS) {
            const float* arow = adj_s + (g * N + n) * N;
            float4 v = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int m = 0; m < kNodes; ++m) {
              if (m < N) {
                const float am = arow[m];
                v.x = fmaf(am, acc[4 * m], v.x);
                v.y = fmaf(am, acc[4 * m + 1], v.y);
                v.z = fmaf(am, acc[4 * m + 2], v.z);
                v.w = fmaf(am, acc[4 * m + 3], v.w);
              }
            }
            v.x += bv.x;
            v.y += bv.y;
            v.z += bv.z;
            v.w += bv.w;
            *reinterpret_cast<float4*>(pre_s + n * M + col) = v;
          }
        }
      }
    }
    clk.mark(4);
    __syncthreads();
    clk.mark(5);
    if (step + 1 < T) prefetch_u(step + 1);

    // gates and the cell, local: unit j of node n reads its four columns
    for (int e = tid; e < N * Hc; e += kThreads) {
      const int n = e / Hc, j = e - n * Hc;
      const float* pr = pre_s + n * MP;
      const float ig = sigmoid_f(pr[j]);
      const float fg = sigmoid_f(pr[Hc + j]);
      const float gg = tanhf(pr[2 * Hc + j]);
      const float og = sigmoid_f(pr[3 * Hc + j]);
      const float cn = fg * c_s[e] + ig * gg;
      c_s[e] = cn;
      const float hy = og * tanhf(cn);
      h_nxt[n * HS + c * Hc + j] = hy;
      if constexpr (!ATT) y_t[(size_t)n * 2 * H + j] = tanhf(hy);
    }
    clk.mark(6);
    __syncthreads();
    clk.mark(7);

    // all-gather the hy slice (without attention: the new h)
    {
      const int q4 = Hc / 4;
      for (int e = tid; e < N * q4; e += kThreads) {
        const int n = e / q4;
        float* src = h_nxt + n * HS + c * Hc + 4 * (e - n * q4);
        const float4 v = *reinterpret_cast<const float4*>(src);
        for (int peer = 0; peer < C; ++peer) {
          if (peer == c) continue;
          if constexpr (ATT)
            st_async(map_rank(src, peer), v, map_rank(mb_h, peer));
          else
            *reinterpret_cast<float4*>(cluster.map_shared_rank(src, peer)) =
                v;
        }
      }
    }
    clk.mark(8);
    if constexpr (ATT) {
      // p_c = (Σ_nodes hy_c)·W_c over all H columns: lane k of every warp
      // sums the nodes of own column k (the operands rounded as q's product
      // takes them, Hc ≤ 32) into the warp's own row of scratch past hy·Wh's
      // planes in pre_s, thread j forms column j from it (no block
      // barrier); 4 adjacent columns go to a peer in one store, the peers
      // spread over the 4 lanes
      if (warp * 32 < H) {
        // all 16 rows, unguarded (a guarded load is a branch, and each load
        // then waits for the one before): rows N … 15 of h stay zero (set
        // so at the start, no store reaches them), so they add nothing
        const float* hp = h_nxt + c * Hc + min(lane, Hc - 1);
        float hs = 0.0f;
#pragma unroll
        for (int n = 0; n < kNodes; ++n)
          hs += operand<TF32>(hp[n * HS]);
        float* sw = pre_s + (KSP * kNodes + warp) * Hc;
        if (lane < Hc) sw[lane] = hs;
        __syncwarp();
        float p_own = 0.0f;      // column tid of this CTA's partial q
#pragma unroll
        for (int i = 0; i < kMaxKw; i += 4) {
          if (i < Hc) {
            const float4 h4 = *reinterpret_cast<const float4*>(sw + i);
            p_own = fmaf(h4.x, ww[i], p_own);
            p_own = fmaf(h4.y, ww[i + 1], p_own);
            p_own = fmaf(h4.z, ww[i + 2], p_own);
            p_own = fmaf(h4.w, ww[i + 3], p_own);
          }
        }
        const int l4 = lane & ~3, j4 = tid & ~3;
        const float4 pv = {__shfl_sync(0xffffffffu, p_own, l4),
                           __shfl_sync(0xffffffffu, p_own, l4 + 1),
                           __shfl_sync(0xffffffffu, p_own, l4 + 2),
                           __shfl_sync(0xffffffffu, p_own, l4 + 3)};
        if (tid < H) q_s[tid] = p_own;
        if (j4 < H) {
          for (int i = lane & 3; i < C - 1; i += 4) {
            const int peer = c + 1 + i < C ? c + 1 + i : c + 1 + i - C;
            st_async(map_rank(q_s + j4, peer), pv, map_rank(mb_h, peer));
          }
        }
      }
      clk.mark(18);
    }
    // With attention the peers' hy slices and partial q of this frame, on
    // one mbarrier phase (the header says why phases cannot mix). Without,
    // nothing orders the peers' frames, so a cluster barrier ends the frame.
    if constexpr (ATT)
      receive(mb_h, ph_h, (int)sizeof(float) * (N * Hc + H));
    else
      cluster.sync();
    clk.mark(9);
    cur ^= 1;
    if constexpr (ATT) {
      // the previous frame's y, from its hy: before this CTA's s·u goes
      // out, since the peers' next hy, into that buffer, waits for it
      if (gate_due) write_y(yf, h_cur);
      clk.mark(15);
      // q = round(relu(Σ_r p_r)), summed in rank order: the same bits in
      // every CTA; into this CTA's slot (its own partial read first)
      if (tid < H) {
        float v = 0.0f;
#pragma unroll
        for (int r = 0; r < kMaxClusterWide; ++r)
          v += r < C ? pq_s[r * kThreads + tid] : 0.0f;
        q_s[tid] = operand<TF32>(fmaxf(v, 0.0f));
      }
      clk.mark(19);
      // own columns of hy·Wh into the KSP planes [16, Hc] of pre_s (free
      // until the next frame's mix), added in order before q·Wq
      if constexpr (MMA) {
        // on the tensor cores, each A fragment rounded as it is loaded
        if (pa < KSP) {
          float p4[4], e4[4];
          mma_zero(p4);
          mma_zero(e4);
          const float* lo = h_nxt + gq * HS + 16 * pa * KBP + 4 * tq;
          const float* hi = lo + 8 * HS;
#pragma unroll
          for (int i = 0; i < kMaxKca / 4; ++i)
            if (i < KBP)
              mma_tf32_k16(
                  p4, e4,
                  operand<true>(*reinterpret_cast<const float4*>(lo + 16 * i)),
                  operand<true>(*reinterpret_cast<const float4*>(hi + 16 * i)),
                  wb[i]);
          mma_sum(p4, e4);
          float* part = pre_s + (size_t)pa * kNodes * Hc + 8 * ta + 2 * tq;
          *reinterpret_cast<float2*>(part + gq * Hc) =
              make_float2(p4[0], p4[1]);
          *reinterpret_cast<float2*>(part + (gq + 8) * Hc) =
              make_float2(p4[2], p4[3]);
        }
      } else if (warp < awarps) {
        // in two passes of 8 nodes (16 accumulators live, not 32)
#pragma unroll 1
        for (int n0 = 0; n0 < kNodes; n0 += kNodes / 2) {
          float acc[kNodes];     // acc[2n + j]: node n0 + n, column colA + j
#pragma unroll
          for (int n = 0; n < kNodes; ++n) acc[n] = 0.0f;
          const float* hp = h_nxt + n0 * H + 4 * ksA;
#pragma unroll
          for (int i = 0; i < kMaxKca / 2; i += 4) {
            if (i < KcA) {
#pragma unroll
              for (int n = 0; n < kNodes / 2; ++n) {
                const float4 hv = operand<TF32>(
                    *reinterpret_cast<const float4*>(hp + n * H + a.KSA * i));
                acc[2 * n] = fmaf(hv.x, wa[2 * i], acc[2 * n]);
                acc[2 * n] = fmaf(hv.y, wa[2 * i + 2], acc[2 * n]);
                acc[2 * n] = fmaf(hv.z, wa[2 * i + 4], acc[2 * n]);
                acc[2 * n] = fmaf(hv.w, wa[2 * i + 6], acc[2 * n]);
                acc[2 * n + 1] = fmaf(hv.x, wa[2 * i + 1], acc[2 * n + 1]);
                acc[2 * n + 1] = fmaf(hv.y, wa[2 * i + 3], acc[2 * n + 1]);
                acc[2 * n + 1] = fmaf(hv.z, wa[2 * i + 5], acc[2 * n + 1]);
                acc[2 * n + 1] = fmaf(hv.w, wa[2 * i + 7], acc[2 * n + 1]);
              }
            }
          }
          reduce_k_slices(acc, cpwA);
          if (cpA < Hc / 2) {
#pragma unroll
            for (int n = 0; n < kNodes / 2; ++n) {
              const int m = n0 + n;
              if (m < N && m % a.KSA == ksA) {
                pre_s[m * Hc + colA] = acc[2 * n];
                pre_s[m * Hc + colA + 1] = acc[2 * n + 1];
              }
            }
          }
        }
      }
      clk.mark(10);
      __syncthreads();
      clk.mark(11);

      // s = tanh(hy·Wh + q·Wq + bs) on own columns
      if (warp < qwarps) {
        float acc[1] = {0.0f};
        for (int j = ksQ; j < H; j += a.KSQ)
          acc[0] = fmaf(q_s[j], wq_s[j * Hc + cqr], acc[0]);
        reduce_k_slices(acc, cpwQ);
        if (colQ < Hc) {
          const float b = bs_s[colQ];
          for (int n = ksQ; n < N; n += a.KSQ) {
            float hw = 0.0f;             // hy·Wh
            for (int p = 0; p < KSP; ++p)
              hw += pre_s[((size_t)p * kNodes + n) * Hc + colQ];
            pre_s[n * Hc + colQ] = operand<TF32>(tanhf(hw + acc[0] + b));
          }
        }
      }
      clk.mark(12);
      __syncthreads();
      clk.mark(13);

      // partial s·u over own columns, one warp per node, to every peer;
      // the next frame waits for them after its h·W_h
      for (int n = warp; n < N; n += kWarps) {
        float v = 0.0f;
        for (int k = lane; k < Hc; k += 32)
          v = fmaf(pre_s[n * Hc + k], au_s[k], v);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        float* dst = apart_s + c * kNodes + n;
        if (lane == c)
          *dst = v;
        else if (lane < C)
          st_async(map_rank(dst, lane), v, map_rank(mb_a, lane));
      }
      yf = frame;
      clk.mark(14);
    }
  }

  cp_async_wait_all();
  __syncthreads();
  const float* h_fin = hb + cur * kNodes * HS;
  if constexpr (ATT) {
    if (yf >= 0) {
      resolve_gate();
      write_y(yf, h_fin);
    }
  }
  for (int e = tid; e < N * Hc; e += kThreads) {
    const int n = e / Hc, j = e - n * Hc;
    float h = h_fin[n * HS + c * Hc + j];
    if constexpr (ATT) h = h + h * sg_s[n];
    a.h_out[st + (size_t)n * H + c * Hc + j] = h;
    a.c_out[st + (size_t)n * H + c * Hc + j] = c_s[e];
  }
  cluster.sync();                // no CTA leaves while its stores travel
  clk.mark(17);
}

struct Plan {
  int C, KS, KSA, KSQ, threads, smem, mma;
};

bool pow2_upto32(int x) { return x > 0 && x <= 32 && (x & (x - 1)) == 0; }

// Shapes the tensor-core path takes: k in 16-deep blocks and W_h^T swizzled
// (H % 32 == 0); 8 warps over 8 or 16 n-tiles of gate columns (M = 64 or
// 128), a warp's tiles in one gate; at most 8 k-blocks of Wh a warp.
bool mma_ok(int H, int Hc, bool attention) {
  const int M = 4 * Hc;
  if (H % 32 != 0 || (M != 64 && M != 128) || Hc % (8 * (M / 64)) != 0)
    return false;
  return !attention || H / 16 / att_split(H, Hc) <= kMaxKca / 4;
}

bool plan_ok(int N, int H, int attention, const Plan& pl, bool tf32) {
  if (N <= 0 || N > kNodes || H <= 0 || H % 4 != 0) return false;
  if (pl.C <= 0 || pl.C > (pl.mma ? kMaxClusterWide : kMaxCluster) ||
      H % pl.C != 0)
    return false;
  const int Hc = H / pl.C, M = 4 * Hc;
  if (Hc % 4 != 0 || M > kThreads || pl.threads != kThreads) return false;
  if (!pow2_upto32(pl.KS) || H % (4 * pl.KS) != 0 ||
      M / 4 * pl.KS > kThreads)
    return false;
  if (attention) {
    if (!pow2_upto32(pl.KSA) || H % (4 * pl.KSA) != 0 ||
        Hc / 2 * pl.KSA > kThreads || 2 * (H / pl.KSA) > kMaxKca)
      return false;
    // q·Wq's k-slices; (Σ_nodes hy_c)·W_c: a thread a column, its weights
    // the Hc own rows in registers
    if (!pow2_upto32(pl.KSQ) || H % (4 * pl.KSQ) != 0 ||
        Hc * pl.KSQ > kThreads || H > kThreads || Hc > kMaxKw)
      return false;
  }
  if (pl.mma != 0 && (pl.mma != 1 || !tf32 || !mma_ok(H, Hc, attention)))
    return false;
  return (size_t)pl.smem ==
         kHeaderBytes + sizeof(float) * smem_floats(N, H, pl.C, attention,
                                                    pl.mma != 0);
}

cudaLaunchConfig_t config(const Plan& pl, int S, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.C, S, 2);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool ATT, bool TF32, bool MMA>
int launch(const Args* a, const Plan& pl, int S, cudaStream_t stream) {
  auto kern = gcn_lstm_kernel<ATT, TF32, MMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err == cudaSuccess && pl.C > kMaxCluster)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return a ? (int)err : -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(pl, S, stream, attr);
  if (!a) {                      // occupancy query
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    return err == cudaSuccess ? clusters : -(int)err;
  }
  err = cudaLaunchKernelEx(&cfg, kern, *a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch(const Args* a, const Plan& pl, int S, bool attention, bool tf32,
           cudaStream_t stream) {
  if (attention) {
    if (!tf32) return launch<true, false, false>(a, pl, S, stream);
    return pl.mma ? launch<true, true, true>(a, pl, S, stream)
                  : launch<true, true, false>(a, pl, S, stream);
  }
  if (!tf32) return launch<false, false, false>(a, pl, S, stream);
  return pl.mma ? launch<false, true, true>(a, pl, S, stream)
                : launch<false, true, false>(a, pl, S, stream);
}

template <bool ATT, bool TF32, bool MMA>
cudaError_t attributes(cudaFuncAttributes* fa) {
  return cudaFuncGetAttributes(fa, gcn_lstm_kernel<ATT, TF32, MMA>);
}

}  // namespace

extern "C" {

// Most clusters of a plan of the fp32 (tf32 = 0) or the TF32 instantiation
// the card holds at once (cudaOccupancyMaxActiveClusters); a negative value
// is minus a cudaError_t.
int gcn_lstm_max_active(int S, int N, int H, int attention, int C, int KS,
                        int KSA, int KSQ, int threads, int smem, int mma,
                        int tf32) {
  const Plan pl{C, KS, KSA, KSQ, threads, smem, mma};
  if (S <= 0 || !plan_ok(N, H, attention, pl, tf32 != 0))
    return -(int)cudaErrorInvalidValue;
  return launch(nullptr, pl, S, attention != 0, tf32 != 0, nullptr);
}

// Registers a thread and local-memory bytes (spills) of the instantiation
// a launch of (attention, tf32, mma) runs, from cudaFuncGetAttributes;
// returns a cudaError_t.
int gcn_lstm_func_attributes(int attention, int tf32, int mma, int* regs,
                             int* local_bytes) {
  cudaFuncAttributes fa = {};
  cudaError_t e;
  if (mma && !tf32) return (int)cudaErrorInvalidValue;
  if (attention)
    e = !tf32 ? attributes<true, false, false>(&fa)
        : mma ? attributes<true, true, true>(&fa)
              : attributes<true, true, false>(&fa);
  else
    e = !tf32 ? attributes<false, false, false>(&fa)
        : mma ? attributes<false, true, true>(&fa)
              : attributes<false, true, false>(&fa);
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)e;
}

// Launches the scan on `stream`, the TF32 instantiation when tf32 != 0;
// returns cudaGetLastError() (0 on success).
int gcn_lstm_forward(const float* u, const float* wh, const float* adj,
                     const float* bias, const float* att_w,
                     const float* att_wq, const float* att_wh,
                     const float* att_u, const float* att_bs,
                     const float* att_bu, const float* h0, const float* c0,
                     const int* n_valid, float* y, float* h_out, float* c_out,
                     int S, int T, int N, int H, int attention, int C, int KS,
                     int KSA, int KSQ, int threads, int smem, int mma,
                     int tf32, cudaStream_t stream) {
  const Plan pl{C, KS, KSA, KSQ, threads, smem, mma};
  if (S <= 0 || T <= 0 || !plan_ok(N, H, attention, pl, tf32 != 0))
    return (int)cudaErrorInvalidValue;
  if (attention && !(att_w && att_wq && att_wh && att_u && att_bs && att_bu))
    return (int)cudaErrorInvalidValue;
  Args a{u, wh, adj, bias, att_w, att_wq, att_wh, att_u, att_bs, att_bu,
         h0, c0, n_valid, y, h_out, c_out, S, T, N, H, C, KS, KSA, KSQ};
  return launch(&a, pl, S, attention != 0, tf32 != 0, stream);
}

const char* gcn_lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

SCAN_PHASE_EXPORT(gcn_lstm)
