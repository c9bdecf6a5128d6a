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
// Per frame, in order (the JAX cell's op order, fp32 FMA throughout, no TF32
// and no bf16 — the numerics of precision="highest"):
//   z   = u_t + h·W_h                         u hoisted by the caller
//   pre = adj[g]·z_g + bias[g]                bias AFTER the graph mix
//   i,f,o = σ(pre), g = tanh(pre); c' = f·c + i·g; hy = o·tanh(c')
//   attention (A3GC/AGC): q = relu(Σ_nodes hy·W), s = tanh(hy·Wh + q·Wq + bs),
//                         (q computed as relu((Σ_nodes hy)·W), the same sum)
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
//     four gate columns of each ([H, 4·Hc] of W_h) and the Hc columns of Wq
//     sit in shared memory, loaded once by cp.async.bulk; its Hc columns of
//     the attention W and Wh sit in registers (32 + 32 per thread, with
//     everything else 255 registers: the budget that bounds this design);
//   * everything up to the cell is local: the z slice for all 16 (padded)
//     node rows (thread = one column × one k-slice, shuffles sum the
//     k-slices), the 15×15 mix of each gate (it mixes rows within a
//     column, so a thread mixes its own column), the bias, the gates, c';
//   * attention, three exchanges a frame and no cluster barrier: each CTA
//     writes its hy slice, its q = relu((Σ_nodes hy)·W) columns and its
//     partial s·u straight into every peer's shared memory with st.async,
//     each store completing its bytes on the receiver's mbarrier (one per
//     exchange), and waits only on its own mbarriers. (A cluster barrier's
//     release is a GPU-scope MEMBAR that waits for every outstanding global
//     store: ~1-2k cycles a barrier on the H100.) One mbarrier phase per
//     frame is safe because a peer's next-frame stores into an exchange
//     depend, through the other two, on this CTA having finished its wait.
//     Order: hy; own columns of q, sent, then of hy·Wh while the peers' q
//     travel; q·Wq and s; the partial s·u, sent and waited for only in the
//     next frame, after its h·W_h: h = hy + hy·σ(a) scales whole node rows,
//     so the product runs on hy and its rows are scaled once every CTA has
//     summed σ(a) from the same partials in the same order (the previous
//     frame's y is written then). No frame updates the full h. Without
//     attention the hy slice is the new h, exchanged by DSMEM stores and
//     one cluster barrier a frame. The full h (or hy) is double-buffered
//     against the peers' stores;
//   * the next frame's u slice is prefetched by cp.async during the cell
//     and the attention; masked frames of a stream (uniform over its
//     cluster) only write y.
// The launch plan (C, k-slices, shared-memory bytes) comes from the Python
// wrapper (ops/gcn_lstm.py launch_plan); the C side recomputes the shared
// memory and refuses a plan that disagrees.
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
constexpr int kMaxCluster = 8;
constexpr int kMaxKw = 32;       // attention W weights per thread (registers):
                                 // 1 column × H / KSQ rows
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

// Row pad of Wq's column slice: k-slice ks of q·Wq reads row j·KSQ + ks,
// so rows KSQ apart must start max(4, 32/KSQ) banks apart (16-byte rows).
__host__ __device__ inline int wq_pad(int KSQ) {
  return 32 / KSQ > 4 ? 32 / KSQ : 4;
}

// Floats of dynamic shared memory after the header. W_h's rows are padded
// by 4 floats: lanes of k-slices 4 rows apart then read different banks.
size_t smem_floats(int N, int H, int C, int KSQ, bool att) {
  const size_t Hc = H / C, M = 4 * Hc;
  size_t f = (size_t)H * (M + 4) + 2 * (size_t)kNodes * H + kNodes * M +
             N * M + N * Hc + M + 4 * (size_t)N * N;
  if (att) f += (size_t)H * (Hc + wq_pad(KSQ)) + kNodes * Hc + 2 * H +
                2 * Hc + C * kNodes + 2 * kNodes;
  return f;
}

template <bool ATT>
__global__ void __launch_bounds__(kThreads, 1) gcn_lstm_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  PhaseClock clk(threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
                 blockIdx.z == 0);
  const int c = blockIdx.x;      // cluster rank (cluster dims (C, 1, 1))
  const int s = blockIdx.y;
  const int d = blockIdx.z;
  const int S = a.S, T = a.T, N = a.N, H = a.H, C = a.C, G = 4 * H;
  const int Hc = H / C, M = 4 * Hc, WS = M + 4, WQ = Hc + wq_pad(a.KSQ);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // the weights
  uint64_t* mb_h = bar + 1;      // this frame's hy slices from the peers
  uint64_t* mb_q = bar + 2;      // their q columns
  uint64_t* mb_a = bar + 3;      // their partial s·u
  float* w_s = reinterpret_cast<float*>(smem_raw + kHeaderBytes);  // [H, WS]
  float* wq_s = w_s + (size_t)H * WS;          // [H, WQ] (attention)
  float* hb = wq_s + (ATT ? (size_t)H * WQ : 0);   // [2, 16, H] full h / hy
  float* pre_s = hb + 2 * kNodes * H;          // [16, M] mixed gates
  float* u_s = pre_s + kNodes * M;             // [N, M] this frame's u
  float* c_s = u_s + N * M;                    // [N, Hc] carried c slice
  float* bias_s = c_s + N * Hc;                // [M]
  float* adj_s = bias_s + M;                   // [4, N, N]
  float* sa_s = adj_s + 4 * N * N;             // [16, Hc] hy·Wh, then s
  float* q_s = sa_s + kNodes * Hc;             // [H]
  float* bs_s = q_s + H;                       // [Hc]
  float* au_s = bs_s + Hc;                     // [Hc]
  float* apart_s = au_s + Hc;                  // [C, 16] partial s·u
  float* sg_s = apart_s + C * kNodes;          // [16] σ(a) of the carried h
  float* bu_s = sg_s + kNodes;                 // [16]
  float* hsum_s = bu_s + kNodes;               // [H] Σ_nodes hy

  // the W_h slice (column block g·H + c·Hc … of every row) and Wq's columns
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(mb_h);
    mbar_init(mb_q);
    mbar_init(mb_a);
    mbar_arrive_expect_tx(
        bar, (uint32_t)(sizeof(float) * H * (M + (ATT ? Hc : 0))));
  }
  __syncthreads();
  const float* wh = a.wh + (size_t)d * H * G;
  for (int e = tid; e < 4 * H; e += kThreads) {
    const int k = e >> 2, g = e & 3;
    bulk_load(w_s + (size_t)k * WS + g * Hc,
              wh + (size_t)k * G + g * H + c * Hc, sizeof(float) * Hc, bar);
  }
  if constexpr (ATT) {
    const float* awq = a.att_wq + (size_t)d * H * H;
    for (int k = tid; k < H; k += kThreads)
      bulk_load(wq_s + (size_t)k * WQ, awq + (size_t)k * H + c * Hc,
                sizeof(float) * Hc, bar);
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
  // q·Wq and (Σ hy)·W: a thread owns one column and k-slice ksQ
  const int cpwQ = 32 / a.KSQ, KcQ = H / a.KSQ;
  const int qwarps = (Hc + cpwQ - 1) / cpwQ;
  const int ksQ = lane / cpwQ, colQ = warp * cpwQ + lane % cpwQ;
  const int cq = colQ < Hc ? colQ : Hc - 1;

  // registers for the whole window: this thread's column of the attention
  // W at k-slice ksQ (ww[i]: the slice's i-th row), and its column pair of
  // Wh at k-slice ksA (wa[2i + j]: column colA + j, the slice's i-th row)
  float ww[ATT ? kMaxKw : 1], wa[ATT ? kMaxKca : 1];
  if constexpr (ATT) {
    const float* aw = a.att_w + (size_t)d * H * H + c * Hc + cq;
#pragma unroll
    for (int i = 0; i < kMaxKw; ++i) {
      const size_t row = 4 * ksQ + a.KSQ * (i & ~3) + (i & 3);
      ww[i] = i < KcQ ? __ldg(aw + row * H) : 0.0f;
    }
    const float* awh = a.att_wh + (size_t)d * H * H + c * Hc + colA;
#pragma unroll
    for (int i = 0; i < kMaxKca / 2; ++i) {
      const size_t row = 4 * ksA + a.KSA * (i & ~3) + (i & 3);
      wa[2 * i] = i < KcA ? __ldg(awh + row * H) : 0.0f;
      wa[2 * i + 1] = i < KcA ? __ldg(awh + row * H + 1) : 0.0f;
    }
  }

  const size_t st = ((size_t)d * S + s) * N * H;
  const int nv = a.n_valid[s];
  for (int e = tid; e < 2 * kNodes * H; e += kThreads)
    hb[e] = e < N * H ? a.h0[st + e] : 0.0f;
  for (int e = tid; e < N * Hc; e += kThreads) {
    const int n = e / Hc;
    c_s[e] = a.c0[st + (size_t)n * H + c * Hc + (e - n * Hc)];
  }
  for (int e = tid; e < M; e += kThreads) {
    const int g = e / Hc;
    bias_s[e] = a.bias[((size_t)d * 4 + g) * H + c * Hc + (e - g * Hc)];
  }
  for (int e = tid; e < 4 * N * N; e += kThreads)
    adj_s[e] = a.adj[(size_t)d * 4 * N * N + e];
  if constexpr (ATT) {
    for (int e = tid; e < Hc; e += kThreads) {
      bs_s[e] = a.att_bs[(size_t)d * H + c * Hc + e];
      au_s[e] = a.att_u[(size_t)d * H + c * Hc + e];
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
      float h = hy[n * H + c * Hc + j];
      if constexpr (ATT) h = h + h * sg_s[n];
      y_f[(size_t)n * 2 * H + j] = tanhf(h);
    }
  };
  // this CTA's next phase of an exchange: (C - 1) peers' `bytes` each
  uint32_t ph_h = 0, ph_q = 0, ph_a = 0;
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
  mbar_wait(bar, 0);
  cluster.sync();                // every peer is running and initialised
  clk.mark(16);

  int cur = 0;
  int yf = -1;       // attention: the frame whose σ(a) is still in flight
  for (int step = 0; step < T; ++step) {
    const int frame = d == 0 ? step : T - 1 - step;
    cp_async_wait_all();
    __syncthreads();             // u_s holds this frame's slice
    clk.mark(0);
    float* h_cur = hb + cur * kNodes * H;
    float* h_nxt = hb + (cur ^ 1) * kNodes * H;
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

    // z = u_t + h·W_h on own columns, all node rows (with attention h·W_h
    // = (hy + hy·σ(a))·W_h: the product on hy, its rows scaled once σ(a) is
    // here); then the graph mix
    const bool gate_due = ATT && yf >= 0;
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
            if constexpr (ATT) {
              const float sg = sg_s[m];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[4 * m + j] = acc[4 * m + j] + acc[4 * m + j] * sg;
            }
            const float4 uv =
                *reinterpret_cast<const float4*>(u_s + m * M + col);
            acc[4 * m] = uv.x + acc[4 * m];
            acc[4 * m + 1] = uv.y + acc[4 * m + 1];
            acc[4 * m + 2] = uv.z + acc[4 * m + 2];
            acc[4 * m + 3] = uv.w + acc[4 * m + 3];
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
    clk.mark(4);
    __syncthreads();
    clk.mark(5);
    if (step + 1 < T) prefetch_u(step + 1);

    // gates and the cell, local: unit j of node n reads its four columns
    for (int e = tid; e < N * Hc; e += kThreads) {
      const int n = e / Hc, j = e - n * Hc;
      const float* pr = pre_s + n * M;
      const float ig = sigmoid_f(pr[j]);
      const float fg = sigmoid_f(pr[Hc + j]);
      const float gg = tanhf(pr[2 * Hc + j]);
      const float og = sigmoid_f(pr[3 * Hc + j]);
      const float cn = fg * c_s[e] + ig * gg;
      c_s[e] = cn;
      const float hy = og * tanhf(cn);
      h_nxt[n * H + c * Hc + j] = hy;
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
        float* src = h_nxt + n * H + c * Hc + 4 * (e - n * q4);
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
    // With attention a peer sends its next hy only after this CTA's q
    // (and so after this wait): one mbarrier phase per frame cannot mix
    // two frames' bytes. Without, nothing orders the peers' frames, so a
    // cluster barrier ends the frame.
    if constexpr (ATT)
      receive(mb_h, ph_h, (int)sizeof(float) * N * Hc);
    else
      cluster.sync();
    clk.mark(9);
    cur ^= 1;
    if constexpr (ATT) {
      // the previous frame's y, from its hy: before this CTA's q goes out,
      // since the peers' next hy, into that buffer, waits for it
      if (gate_due) write_y(yf, h_cur);
      clk.mark(15);
      // q = relu((Σ_nodes hy)·W) on own columns, to every peer
      for (int k = tid; k < H; k += kThreads) {
        float v = 0.0f;
        for (int n = 0; n < N; ++n) v += h_nxt[n * H + k];
        hsum_s[k] = v;
      }
      __syncthreads();
      clk.mark(18);
      if (warp < qwarps) {
        float acc[1] = {0.0f};
        const float* hp = hsum_s + 4 * ksQ;
#pragma unroll
        for (int i = 0; i < kMaxKw; i += 4) {
          if (i < KcQ) {
            const float4 hv = *reinterpret_cast<const float4*>(hp + a.KSQ * i);
            acc[0] = fmaf(hv.x, ww[i], acc[0]);
            acc[0] = fmaf(hv.y, ww[i + 1], acc[0]);
            acc[0] = fmaf(hv.z, ww[i + 2], acc[0]);
            acc[0] = fmaf(hv.w, ww[i + 3], acc[0]);
          }
        }
        reduce_k_slices(acc, cpwQ);
        const float q = fmaxf(acc[0], 0.0f);
        if (cpwQ >= 4) {         // 4 neighbouring columns in one store
          const float4 qv = {q, __shfl_down_sync(0xffffffffu, q, 1),
                             __shfl_down_sync(0xffffffffu, q, 2),
                             __shfl_down_sync(0xffffffffu, q, 3)};
          if (colQ < Hc && ksQ == 0 && lane % 4 == 0) {
            float* dst = q_s + c * Hc + colQ;
            *reinterpret_cast<float4*>(dst) = qv;
            for (int r = 0; r < C; ++r)
              if (r != c) st_async(map_rank(dst, r), qv, map_rank(mb_q, r));
          }
        } else if (colQ < Hc && ksQ == 0) {
          float* dst = q_s + c * Hc + colQ;
          *dst = q;
          for (int r = 0; r < C; ++r)
            if (r != c) st_async(map_rank(dst, r), q, map_rank(mb_q, r));
        }
      }
      clk.mark(19);
      // the peers' q columns are waited for after hy·Wh
      // own columns of hy·Wh (→ sa_s)
      if (warp < awarps) {
        float acc[2 * kNodes];   // acc[2n + j]: node n, column colA + j
#pragma unroll
        for (int n = 0; n < 2 * kNodes; ++n) acc[n] = 0.0f;
        const float* hp = h_nxt + 4 * ksA;
#pragma unroll
        for (int i = 0; i < kMaxKca / 2; i += 4) {
          if (i < KcA) {
#pragma unroll
            for (int n = 0; n < kNodes; ++n) {
              const float4 hv =
                  *reinterpret_cast<const float4*>(hp + n * H + a.KSA * i);
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
          for (int n = 0; n < kNodes; ++n) {
            if (n < N && n % a.KSA == ksA) {
              sa_s[n * Hc + colA] = acc[2 * n];
              sa_s[n * Hc + colA + 1] = acc[2 * n + 1];
            }
          }
        }
      }
      clk.mark(10);
      receive(mb_q, ph_q, (int)sizeof(float) * Hc);
      __syncthreads();
      clk.mark(11);

      // s = tanh(hy·Wh + q·Wq + bs) on own columns
      if (warp < qwarps) {
        float acc[1] = {0.0f};
        for (int j = ksQ; j < H; j += a.KSQ)
          acc[0] = fmaf(q_s[j], wq_s[j * WQ + cq], acc[0]);
        reduce_k_slices(acc, cpwQ);
        if (colQ < Hc) {
          const float b = bs_s[colQ];
          for (int n = ksQ; n < N; n += a.KSQ)
            sa_s[n * Hc + colQ] = tanhf(sa_s[n * Hc + colQ] + acc[0] + b);
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
          v = fmaf(sa_s[n * Hc + k], au_s[k], v);
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
  const float* h_fin = hb + cur * kNodes * H;
  if constexpr (ATT) {
    if (yf >= 0) {
      resolve_gate();
      write_y(yf, h_fin);
    }
  }
  for (int e = tid; e < N * Hc; e += kThreads) {
    const int n = e / Hc, j = e - n * Hc;
    float h = h_fin[n * H + c * Hc + j];
    if constexpr (ATT) h = h + h * sg_s[n];
    a.h_out[st + (size_t)n * H + c * Hc + j] = h;
    a.c_out[st + (size_t)n * H + c * Hc + j] = c_s[e];
  }
  cluster.sync();                // no CTA leaves while its stores travel
  clk.mark(17);
}

struct Plan {
  int C, KS, KSA, KSQ, threads, smem;
};

bool pow2_upto32(int x) { return x > 0 && x <= 32 && (x & (x - 1)) == 0; }

bool plan_ok(int N, int H, int attention, const Plan& pl) {
  if (N <= 0 || N > kNodes || H <= 0 || H % 4 != 0) return false;
  if (pl.C <= 0 || pl.C > kMaxCluster || H % pl.C != 0) return false;
  const int Hc = H / pl.C, M = 4 * Hc;
  if (Hc % 4 != 0 || M > kThreads || pl.threads != kThreads) return false;
  if (!pow2_upto32(pl.KS) || H % (4 * pl.KS) != 0 ||
      M / 4 * pl.KS > kThreads)
    return false;
  if (attention) {
    if (!pow2_upto32(pl.KSA) || H % (4 * pl.KSA) != 0 ||
        Hc / 2 * pl.KSA > kThreads || 2 * (H / pl.KSA) > kMaxKca)
      return false;
    if (!pow2_upto32(pl.KSQ) || H % (4 * pl.KSQ) != 0 ||
        Hc * pl.KSQ > kThreads || H / pl.KSQ > kMaxKw)
      return false;
  }
  return (size_t)pl.smem ==
         kHeaderBytes +
             sizeof(float) * smem_floats(N, H, pl.C, pl.KSQ, attention);
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

template <bool ATT>
int launch(const Args* a, const Plan& pl, int S, cudaStream_t stream) {
  auto kern = gcn_lstm_kernel<ATT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
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

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of a plan, in bytes.
size_t gcn_lstm_smem_bytes(int N, int H, int C, int KSQ, int attention) {
  if (H <= 0 || C <= 0 || H % C != 0 || KSQ <= 0) return 0;
  return kHeaderBytes +
         sizeof(float) * smem_floats(N, H, C, KSQ, attention != 0);
}

// Most clusters of a plan the card holds at once
// (cudaOccupancyMaxActiveClusters); a negative value is minus a cudaError_t.
int gcn_lstm_max_active(int S, int N, int H, int attention, int C, int KS,
                        int KSA, int KSQ, int threads, int smem) {
  const Plan pl{C, KS, KSA, KSQ, threads, smem};
  if (S <= 0 || !plan_ok(N, H, attention, pl))
    return -(int)cudaErrorInvalidValue;
  return attention ? launch<true>(nullptr, pl, S, nullptr)
                   : launch<false>(nullptr, pl, S, nullptr);
}

// Launches the scan on `stream`; returns cudaGetLastError() (0 on success).
int gcn_lstm_forward(const float* u, const float* wh, const float* adj,
                     const float* bias, const float* att_w,
                     const float* att_wq, const float* att_wh,
                     const float* att_u, const float* att_bs,
                     const float* att_bu, const float* h0, const float* c0,
                     const int* n_valid, float* y, float* h_out, float* c_out,
                     int S, int T, int N, int H, int attention, int C, int KS,
                     int KSA, int KSQ, int threads, int smem,
                     cudaStream_t stream) {
  const Plan pl{C, KS, KSA, KSQ, threads, smem};
  if (S <= 0 || T <= 0 || !plan_ok(N, H, attention, pl))
    return (int)cudaErrorInvalidValue;
  if (attention && !(att_w && att_wq && att_wh && att_u && att_bs && att_bu))
    return (int)cudaErrorInvalidValue;
  Args a{u, wh, adj, bias, att_w, att_wq, att_wh, att_u, att_bs, att_bu,
         h0, c0, n_valid, y, h_out, c_out, S, T, N, H, C, KS, KSA, KSQ};
  return attention ? launch<true>(&a, pl, S, stream)
                   : launch<false>(&a, pl, S, stream);
}

const char* gcn_lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

SCAN_PHASE_EXPORT(gcn_lstm)
