// Dense LSTM scan (the DIP / TransPose layers) for Hopper, sm_90a:
// weight-stationary across SMs, D = 2 directions (the biLSTM) or D = 1 (the
// unidirectional DIP net).
//
// Replaces _lstm_kernel (a3gc_tpu/ops/pallas_gcn_lstm.py:580), which
// lstm_scan_pallas launches once per direction over B rows with ONE scalar
// n_valid for all of them. Here one launch runs all D directions, and the
// valid length is per stream (n_valid [S]): the contract of the XLA path of
// dip_apply, whose frame_mask is per row, and what serving with an idle
// slot needs.
//
// Per frame, in order (fp32 FMA throughout, no bf16; the TF32 instantiation,
// a net's precision="default" on the card, rounds W_hh once when it lands in
// shared memory and h where it is written for the product, so that the FMA
// loop multiplies TF32 operands exactly and sums in fp32 — one tensor-core
// pass's arithmetic, as XLA's Precision.DEFAULT on this card):
//   z = u_t + h·W_hh            u = x·W_ih + b_ih + b_hh, hoisted by the
//                               caller, so the kernel adds no bias
//   i, f, o = σ(z_i, z_f, z_o); g = tanh(z_g)      gate order i, f, g, o
//   c' = f·c + i·g; h' = o·tanh(c')
//   frame < n_valid[stream] ? (h, c) = (h', c') : keep (h, c)
//   y[s, frame, d·H:(d+1)·H] = h                   (no tanh)
// The backward direction walks frame = T-1 … 0 and reads u in forward
// frame order, as the Pallas index map does.
//
// What bounds it: 8·H² FLOP per frame, stream and direction, sequential
// over frames, on a matrix (W_hh, 1 MiB per direction at H = 256, 4 MiB at
// H = 512) that one SM can neither hold nor stream from L2 fast enough.
// The design spreads the matrix over P CTAs on P SMs and keeps it there:
//   * work split: per (direction, block of R ≤ 8 streams) a group of P
//     CTAs; CTA p owns hidden units [p·Hc, (p+1)·Hc), Hc = H / P, and the
//     four gate columns of each, a [H, 4·Hc] slice of W_hh loaded ONCE into
//     shared memory by cp.async.bulk. Each frame it computes its slice of z
//     for all R streams from shared memory (thread = one column × one
//     k-slice, R accumulators, the KS k-slices summed by warp shuffles) and
//     updates its (h, c) slice locally;
//   * exchange: the new h slice goes to every CTA of the group. With P ≤ 8
//     the group is a thread-block cluster: DSMEM stores into each peer's
//     full-h buffer, double-buffered so that one cluster barrier per frame
//     suffices. Past P = 8 — H = 256 at 64 gate columns a CTA (P = 16),
//     H = 512, whose 4 MiB W_hh needs P = 32 at 128 KB a slice — more than
//     a cluster holds, so the group is a cooperative launch (every CTA
//     resident, or the launch is refused) exchanging h through an L2
//     buffer behind a release/acquire counter per (direction, group),
//     epoch = frames exchanged so far; the caller zeroes the counters;
//   * the next frame's u slice is prefetched by cp.async while the current
//     frame's exchange and the next h·W_hh run; frames where no stream of
//     the block is valid only write y;
//   * the full h the product reads is its operand (TF32: rounded, in every
//     CTA's buffer and in the L2 exchange); each CTA keeps its own columns
//     of h in fp32 beside it ([R, Hc]) for the cell, y and h_out.
// The TF32 instantiation's tensor-core form (plan field mma = 1, every
// dense serving width: clusters of 2 / 8 / 8 at H = 64 / 128 / 256, the
// cooperative 32 at H = 512; the FMA loop above stays for the plans it
// refuses, mma = 0). What held the FMA loop back at TF32 (phase clocks,
// scripts/torch_kernel_phases.py --tf32, H = 64, P = 4, S = 8): the scalar
// product (1.8k SM cycles a frame) and the cluster's DSMEM push and
// barrier (1.5k), then the cell (1.0k). Here:
//   * z^T [M, R] = (W_hh slice)^T [M, H] · h^T [H, R] on mma.sync m16n8k8
//     TF32 (scan_common.cuh mma_tf32_k16): A is W_hh^T in 16-row tiles of
//     the CTA's M = 4·Hc gate columns, k = H in 16-deep blocks; B is h^T,
//     n = 8 streams (R < 8: the missing rows of the full h are zero, so
//     S = 1 still takes one instruction a tile and k-step);
//   * A is stationary in registers: warp w takes k part q = w / (8 / KS)
//     (the plan's KS is the number of k parts, 1 or 2, k split evenly; 2
//     where the tiles leave half the warps idle) and tile w % (8 / KS); its
//     fragments, NKB = 4 or 16 k-blocks × 8 floats (at most 128 registers
//     a thread; M ≤ 128 / KS gate columns a CTA), are read once a
//     launch from the W_hh slice that the FMA form's bulk copy stages in
//     shared memory, and rounded (scalar loads from global memory took 10k
//     SM cycles for 64 KB). No frame reads A from shared memory: a width
//     whose fragments exceed 128 registers at every split (H = 512 below
//     P = 32) takes another P or the FMA form;
//   * B fragments are 16-byte loads of the full h, whose rows are padded to
//     mma_row_stride(H) floats (≡ 16 mod 32: the two rows a quarter-warp
//     reads fall on distinct banks); 8 rows in every plan, zero past R;
//   * a warp's two accumulators are summed (mma_sum) and its D fragments
//     go to its k part's z slice (rows padded to M + 4 floats: the 4 lanes
//     of a fragment column write distinct banks); the cell sums the k
//     parts in order, part 0 first;
//   * no cluster barrier a frame: in a cluster each thread sends its new h
//     to the peers' full-h buffers by st.async, each store completing its
//     bytes on the peer's mbarrier (one a buffer), and a CTA waits on its
//     own before its product (phase 2); one CTA (P = 1) exchanges nothing.
//     A peer's stores into a buffer follow, through the other buffer's
//     exchange, this CTA's last read of it. The cooperative grid keeps the
//     L2 exchange;
//   * the cell, the masking, y, the u prefetch and the phase marks are the
//     FMA form's.
// Both forms fix a thread's (at most 2) units of the cell and 16-byte
// chunks of u for a block, and take a unit's exponentials before its
// divisions: the cell's latency, not its arithmetic, is what a frame of
// one unit a thread waits for (PERF.md).
// The launch plan (P, KS, R, groups, cluster or cooperative, shared-memory
// bytes) comes from the Python wrapper (ops/lstm.py launch_plan); the C
// side recomputes the shared memory and refuses a plan that disagrees.
//
// Layouts (all contiguous fp32 unless noted):
//   u [D, S, T, 4H]   W_hh [D, H, 4H]   h0, c0, h_out, c_out [D, S, H]
//   n_valid [S] int32   y [S, T, D·H]   (direction d is blockIdx.z)
//   cooperative only: xchg [D, groups, 2, R, H], counter [D, groups] u32
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (a3gc_tpu_torch/ops/_build.py); bound to PyTorch
// with ctypes (a3gc_tpu_torch/ops/lstm.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace scan;

constexpr int kMaxRows = 8;      // streams per group
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFragBlocks = 16;   // k-blocks of A a warp holds: 128
                                     // registers a thread

struct Args {
  const float* u;
  const float* whh;
  const float* h0;
  const float* c0;
  const int* n_valid;
  float* y;
  float* h_out;
  float* c_out;
  float* xchg;
  unsigned* counter;
  int S, T, H, D, P, KS, R;
};

// The tensor-core form's split of a CTA's product over its 8 warps, from
// the plan's k parts KS (1 or 2: the cell adds them in a fixed order):
// MT = M / 16 tiles, one a warp of each k part, KB = H / 16 k-blocks, NKB
// of them a warp: 4 or 16, the instantiations the serving widths' plans
// run (each one more kernel for nvcc to build). Valid where ok().
struct MmaSplit {
  int MT, KB, NKB;
  MmaSplit(int H, int P, int KS)
      : MT(4 * (H / P) / 16), KB(H / 16), NKB(KS > 0 ? KB / KS : 0) {}
  bool ok(int H, int P, int KS) const {
    if (H % 16 != 0 || (4 * (H / P)) % 16 != 0 || KS < 1 || KS > 2 ||
        KB % KS != 0 || MT * KS > kWarps)
      return false;
    return NKB == 4 || NKB == kMaxFragBlocks;
  }
};

// Floats of dynamic shared memory after the header. The FMA form: W_hh's
// slice with rows padded by 4 floats (lanes of k-slices 4 rows apart then
// read different banks), the full h of R streams (double-buffered in a
// cluster), z and u slices [R, M], c and h slices [R, Hc]. The tensor-core
// form stages W_hh's slice the same way (its A fragments come from there
// into registers), then the full h of 8 rows padded to mma_row_stride(H),
// the KS k parts' z slices [R, M + 4], u, c and h as the FMA form.
size_t smem_floats(int R, int H, int P, bool coop, bool mma, int KS) {
  const size_t Hc = H / P, M = 4 * Hc, nbuf = coop ? 1 : 2;
  if (mma)
    return (size_t)H * (M + 4) + nbuf * kMaxRows * (size_t)mma_row_stride(H) +
           (size_t)KS * R * (M + 4) + (size_t)R * M + 2 * (size_t)R * Hc;
  return (size_t)H * (M + 4) + nbuf * (size_t)R * H + 2 * (size_t)R * M +
         2 * (size_t)R * Hc;
}

// RT: streams per group of the FMA form (its accumulators); 0 in the
// tensor-core form, whose R is the plan's (a.R). NKB > 0: the tensor-core
// form, a warp's A fragments NKB k-blocks of one tile.
template <int RT, bool COOP, bool TF32, int NKB = 0>
__global__ void __launch_bounds__(kThreads, 1) lstm_kernel(Args a) {
  constexpr bool MMA = NKB > 0;
  static_assert(TF32 || !MMA, "the tensor cores take TF32 operands");
  PhaseClock clk(threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
                 blockIdx.z == 0);
  const int p = blockIdx.x;      // cluster rank (cluster dims (P, 1, 1))
  const int d = blockIdx.z;
  const int S = a.S, T = a.T, H = a.H, P = a.P, KS = a.KS, G = 4 * H;
  const int R = MMA ? a.R : RT;
  const size_t YW = (size_t)a.D * H;   // y's row: the D directions' h
  const int Hc = H / P, M = 4 * Hc, WS = M + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_blocks = (S + R - 1) / R;
  // the full h: HR rows of stride HS; z: KZ k parts of rows ZS apart
  const int HS = MMA ? mma_row_stride(H) : H, HR = MMA ? kMaxRows : R;
  const int KZ = MMA ? KS : 1, ZS = MMA ? M + 4 : M;
  // the tensor-core form's cluster exchanges h by st.async (P > 1)
  const bool async_x = MMA && !COOP && P > 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int* nv_s = reinterpret_cast<int*>(smem_raw + 16);          // [R]
  uint64_t* hbar = reinterpret_cast<uint64_t*>(smem_raw + 48);  // [2]
  float* w_s = reinterpret_cast<float*>(smem_raw + kHeaderBytes);  // [H, WS]
  float* h_buf = w_s + (size_t)H * WS;  // [1 or 2, HR, HS]
  float* z_s = h_buf + (COOP ? 1 : 2) * HR * HS;   // [KZ, R, ZS] h·W_hh
  float* u_s = z_s + KZ * R * ZS;       // [R, M] this frame's u slice
  float* c_s = u_s + R * M;             // [R, Hc] carried c slice
  float* hown_s = c_s + R * Hc;         // [R, Hc] carried h slice, fp32

  const float* whh = a.whh + (size_t)d * H * G;
  // the W_hh slice: column block g·H + p·Hc … of every row k, into shared
  // memory by cp.async.bulk ([H, WS]); the tensor-core form then takes
  // warp w's A fragments from it (tile i row m = slice column m), rounded
  // to TF32, and holds them in registers for the launch
  if (tid == 0) {
    mbar_init(bar);
    mbar_arrive_expect_tx(bar, (uint32_t)(sizeof(float) * H * M));
    if (async_x) {
      mbar_init(&hbar[0]);
      mbar_init(&hbar[1]);
    }
  }
  __syncthreads();
  for (int e = tid; e < 4 * H; e += kThreads) {
    const int k = e >> 2, g = e & 3;
    bulk_load(w_s + (size_t)k * WS + g * Hc,
              whh + (size_t)k * G + g * H + p * Hc, sizeof(float) * Hc, bar);
  }
  const int gq = lane >> 2, tq = lane & 3;   // an mma fragment's (g, t)
  const int wpk = MMA ? kWarps / KS : 1, kq = warp / wpk, ti0 = warp % wpk;
  const int MT = M / 16;
  float4 af[MMA ? 2 * NKB : 1];
  if constexpr (MMA) {
    mbar_wait(bar, 0);
    if (ti0 < MT) {
#pragma unroll
      for (int b = 0; b < NKB; ++b) {
        const float* src = w_s + (size_t)(16 * (kq * NKB + b) + 4 * tq) * WS;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int m = 16 * ti0 + gq + 8 * hi;
          af[2 * b + hi] = make_float4(
              tf32_round(src[m]), tf32_round(src[WS + m]),
              tf32_round(src[2 * WS + m]), tf32_round(src[3 * WS + m]));
        }
      }
    }
    clk.mark(21);
  }

  unsigned epoch = 0;       // frames exchanged so far (cooperative counter)
  const int cpw = 32 / KS;  // FMA form: columns a warp, KS k-slices each
  const int zwarps = (M + cpw - 1) / cpw;
  const int ks = lane / cpw;
  const int col = warp * cpw + lane % cpw;
  const int colr = col < M ? col : M - 1;

  for (int sb = blockIdx.y; sb < n_blocks; sb += gridDim.y) {
    const int s0 = sb * R;
    const int rows = S - s0 < R ? S - s0 : R;
    unsigned* ctr = COOP ? a.counter + d * gridDim.y + blockIdx.y : nullptr;
    float* xg = COOP ? a.xchg + (size_t)(d * gridDim.y + blockIdx.y) * 2 * R * H
                     : nullptr;

    __syncthreads();              // the previous block's readers are done
    if (tid < R) nv_s[tid] = tid < rows ? a.n_valid[s0 + tid] : 0;
    for (int e = tid; e < (COOP ? 1 : 2) * HR * HS; e += kThreads) {
      const int r = (e / HS) % HR, k = e % HS;
      const bool first = e < HR * HS;
      h_buf[e] = first && r < rows && k < H
                     ? operand<TF32>(a.h0[((size_t)d * S + s0 + r) * H + k])
                     : 0.0f;
    }
    for (int e = tid; e < R * Hc; e += kThreads) {
      const int r = e / Hc;
      const size_t g = ((size_t)d * S + s0 + r) * H + p * Hc + (e - r * Hc);
      c_s[e] = r < rows ? a.c0[g] : 0.0f;
      hown_s[e] = r < rows ? a.h0[g] : 0.0f;
    }
    // a thread's units of the cell (e = tid + 256·i) and 16-byte chunks of
    // the u slice, fixed for the block: at most 2 of each, as rows·Hc and
    // rows·M/4 are at most 8·64 (M ≤ 256); their offsets once, not a frame
    // (past the end: unit or chunk 0, never used)
    const int n_units = rows * Hc, n_chunks = rows * (M / 4);
    int unit_r[2], unit_j[2];
    float* unit_y[2];             // y at frame 0
    const float* chunk_src[2];    // u at frame 0
    float* chunk_dst[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + kThreads * i < n_units ? tid + kThreads * i : 0;
      unit_r[i] = e / Hc;
      unit_j[i] = e - unit_r[i] * Hc;
      unit_y[i] = a.y + (size_t)(s0 + unit_r[i]) * T * YW + (size_t)d * H +
                  p * Hc + unit_j[i];
      const int c = tid + kThreads * i < n_chunks ? tid + kThreads * i : 0;
      const int r = c / (M / 4), q = c - r * (M / 4);
      const int g = (4 * q) / Hc, j = 4 * q - g * Hc;
      chunk_src[i] = a.u + ((size_t)d * S + s0 + r) * T * G + g * H +
                     p * Hc + j;
      chunk_dst[i] = u_s + r * M + 4 * q;
    }
    auto prefetch_u = [&](int step) {
      const size_t f = (size_t)(d == 0 ? step : T - 1 - step) * G;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (tid + kThreads * i < n_chunks)
          cp_async16(chunk_dst[i], chunk_src[i] + f);
      cp_async_commit();
    };
    prefetch_u(0);
    if constexpr (!MMA) {
      if (sb == (int)blockIdx.y) {
        mbar_wait(bar, 0);
        round_smem<TF32>(w_s, H, M, WS);
      }
    }
    __syncthreads();
    if constexpr (!COOP) cg::this_cluster().sync();   // peers are running
    clk.mark(16);

    int cur = 0, nv_max = 0;
    for (int r = 0; r < R; ++r) nv_max = max(nv_max, nv_s[r]);
    const unsigned block_epoch = epoch;
    // st.async exchange: the peers' slices of the full h that the
    // exchange of frame n (n = 0, 1, … this block) sent, (P - 1)·rows·Hc
    // floats, complete on hbar[(n + 1) & 1], its phase (n >> 1) & 1
    const uint32_t x_bytes = sizeof(float) * (P - 1) * rows * Hc;
    auto wait_exchange = [&](unsigned n) {
      if (tid == 0) mbar_arrive_expect_tx(&hbar[(n + 1) & 1], x_bytes);
      mbar_wait_cluster(&hbar[(n + 1) & 1], (n >> 1) & 1);
    };
    for (int step = 0; step < T; ++step) {
      const int frame = d == 0 ? step : T - 1 - step;
      float* h_cur = h_buf + cur * HR * HS;

      if (frame >= nv_max) {      // every stream of the block carries: y = h
        cp_async_wait_all();
        if (step + 1 < T) prefetch_u(step + 1);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (tid + kThreads * i < n_units)
            unit_y[i][(size_t)frame * YW] = hown_s[tid + kThreads * i];
        clk.mark(1);
        continue;
      }

      clk.mark(0);
      if constexpr (COOP) {       // the full h of this frame from L2
        if (tid == 0)
          while (ld_acquire(ctr) < (unsigned)P * epoch) {
          }
        __syncthreads();
        if (epoch > block_epoch) {   // h0 until this block's first exchange
          const float4* src = reinterpret_cast<const float4*>(
              xg + (size_t)(epoch & 1) * R * H);
          const int q4 = H / 4;
          for (int e = tid; e < rows * q4; e += kThreads) {
            const int r = e / q4;
            reinterpret_cast<float4*>(h_cur + r * HS)[e - r * q4] =
                __ldcg(src + e);
          }
          __syncthreads();
        }
        clk.mark(2);
      } else if (async_x) {       // the peers' slices of this frame's h
        if (epoch > block_epoch) wait_exchange(epoch - block_epoch - 1);
        clk.mark(2);
      }

      if constexpr (MMA) {
        // z^T tile of this warp over its k part, on the tensor cores
        if (ti0 < MT) {
          float dz[4], ez[4];
          mma_zero(dz);
          mma_zero(ez);
          const float* bp = h_cur + gq * HS + 16 * kq * NKB + 4 * tq;
#pragma unroll
          for (int b = 0; b < NKB; ++b)
            mma_tf32_k16(dz, ez, af[2 * b], af[2 * b + 1],
                         *reinterpret_cast<const float4*>(bp + 16 * b));
          mma_sum(dz, ez);
          float* zq = z_s + (size_t)kq * R * ZS + 16 * ti0 + gq;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 2 * tq + c;
            if (r < R) {
              zq[r * ZS] = dz[c];
              zq[r * ZS + 8] = dz[2 + c];
            }
          }
        }
      } else if (warp < zwarps) {
        // z slice = h·W_hh[:, own columns], all R streams at once; k-slice
        // ks takes the float4 groups k = 4·ks, 4·ks + 4·KS, … so that the
        // slices' broadcast reads of h land in different banks
        float acc[MMA ? 1 : RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
        const float* wp = w_s + colr;
        const float* hp = h_cur;
        for (int k = 4 * ks; k < H; k += 4 * KS) {
          const float w0 = wp[(k + 0) * WS], w1 = wp[(k + 1) * WS];
          const float w2 = wp[(k + 2) * WS], w3 = wp[(k + 3) * WS];
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(hp + r * H + k);
            acc[r] = fmaf(hv.x, w0, acc[r]);
            acc[r] = fmaf(hv.y, w1, acc[r]);
            acc[r] = fmaf(hv.z, w2, acc[r]);
            acc[r] = fmaf(hv.w, w3, acc[r]);
          }
        }
        reduce_k_slices(acc, cpw);
        if (col < M) {
#pragma unroll
          for (int r = 0; r < RT; ++r)
            if (r % KS == ks) z_s[r * M + col] = acc[r];
        }
      }
      clk.mark(3);
      cp_async_wait_all();
      __syncthreads();
      clk.mark(4);

      // the cell, local: unit j of stream r reads its four gate columns
      // (the tensor-core form: its k parts' sums, in order), a thread's
      // units (at most 2) in turn; the exponentials and tanh of the gates
      // first, then the divisions (each a branch to a slow path that no
      // other work crosses): sigmoid_f's operations in another order
      float* h_new = COOP ? h_cur : h_buf + (cur ^ 1) * HR * HS;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (tid + kThreads * i >= n_units) break;
        const int r = unit_r[i], j = unit_j[i], e = r * Hc + j;
        const float* zr = z_s + r * ZS;
        const float* ur = u_s + r * M;
        auto zc = [&](int c) {         // part 0, then part 1
          float z = zr[c];
          if (KZ > 1) z += zr[R * ZS + c];
          return z;
        };
        const float ei = expf(-(ur[j] + zc(j)));
        const float ef = expf(-(ur[Hc + j] + zc(Hc + j)));
        const float gg = tanhf(ur[2 * Hc + j] + zc(2 * Hc + j));
        const float eo = expf(-(ur[3 * Hc + j] + zc(3 * Hc + j)));
        const float ig = 1.0f / (1.0f + ei), fg = 1.0f / (1.0f + ef);
        const float c = fg * c_s[e] + ig * gg;
        float h = hown_s[e];
        if (frame < nv_s[r]) {
          c_s[e] = c;
          hown_s[e] = h = (1.0f / (1.0f + eo)) * tanhf(c);
        }
        const float hx = operand<TF32>(h);
        float* dst = h_new + r * HS + p * Hc + j;
        *dst = hx;
        if constexpr (COOP)
          xg[(size_t)((epoch + 1) & 1) * R * H + r * H + p * Hc + j] = hx;
        if (async_x) {
          uint64_t* mb = &hbar[(epoch - block_epoch + 1) & 1];
          for (int q = 0; q < P; ++q)
            if (q != p) st_async(map_rank(dst, q), hx, map_rank(mb, q));
        }
        unit_y[i][(size_t)frame * YW] = h;
      }
      clk.mark(5);
      __syncthreads();
      clk.mark(6);
      if (step + 1 < T) prefetch_u(step + 1);
      clk.mark(7);

      if constexpr (COOP) {
        if (tid == 0) {
          __threadfence();
          red_release_add(ctr, 1u);
        }
      } else if (MMA) {
        cur ^= 1;                 // sent by st.async above (P > 1)
      } else {
        cg::cluster_group cluster = cg::this_cluster();
        const int q4 = Hc / 4, slice = rows * q4;
        for (int e = tid; e < (P - 1) * slice; e += kThreads) {
          const int k = e / slice, rem = e - k * slice;
          const int peer = k < p ? k : k + 1;
          const int r = rem / q4;
          float* src = h_new + r * HS + p * Hc + 4 * (rem - r * q4);
          *reinterpret_cast<float4*>(cluster.map_shared_rank(src, peer)) =
              *reinterpret_cast<const float4*>(src);
        }
        clk.mark(8);
        cluster.sync();
        cur ^= 1;
      }
      clk.mark(9);
      ++epoch;
    }

    cp_async_wait_all();
    for (int e = tid; e < rows * Hc; e += kThreads) {
      const int r = e / Hc, j = e - r * Hc;
      const size_t g = ((size_t)d * S + s0 + r) * H + p * Hc + j;
      a.h_out[g] = hown_s[e];
      a.c_out[g] = c_s[e];
    }
    // the last exchange's stores have landed before any CTA leaves
    if (async_x && epoch > block_epoch) wait_exchange(epoch - block_epoch - 1);
  }
  if constexpr (MMA && !COOP) cg::this_cluster().sync();
  clk.mark(17);
}

struct Plan {
  int D, R, P, KS, groups, coop, threads, smem, mma;
};

cudaLaunchAttribute group_attr(const Plan& pl) {
  cudaLaunchAttribute attr;
  if (pl.coop) {
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
  } else {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = pl.P;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
  }
  return attr;
}

// Launch (a != null) or the occupancy query (a == null: groups the card
// holds at once, or minus a cudaError_t) of one instantiation.
template <int RT, bool COOP, bool TF32, int NKB>
int run(const Args* a, const Plan& pl, cudaStream_t stream) {
  auto kern = lstm_kernel<RT, COOP, TF32, NKB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return a ? (int)err : -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.P, pl.groups, pl.D);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {group_attr(pl)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (a) {
    err = cudaLaunchKernelEx(&cfg, kern, *a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (COOP) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, pl.smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return err == cudaSuccess ? per_sm * sms : -(int)err;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

template <bool COOP, bool TF32>
int dispatch_fma(const Args* a, const Plan& pl, cudaStream_t stream) {
  switch (pl.R) {
    case 1:
      return run<1, COOP, TF32, 0>(a, pl, stream);
    case 2:
      return run<2, COOP, TF32, 0>(a, pl, stream);
    case 4:
      return run<4, COOP, TF32, 0>(a, pl, stream);
    default:
      return run<kMaxRows, COOP, TF32, 0>(a, pl, stream);
  }
}

template <bool COOP>
int dispatch_mma(const Args* a, const Plan& pl, int NKB,
                 cudaStream_t stream) {
  return NKB == 4 ? run<0, COOP, true, 4>(a, pl, stream)
                  : run<0, COOP, true, kMaxFragBlocks>(a, pl, stream);
}

int dispatch(const Args* a, const Plan& pl, int H, bool tf32,
             cudaStream_t stream) {
  if (pl.mma) {
    const int NKB = MmaSplit(H, pl.P, pl.KS).NKB;
    return pl.coop ? dispatch_mma<true>(a, pl, NKB, stream)
                   : dispatch_mma<false>(a, pl, NKB, stream);
  }
  if (pl.coop)
    return tf32 ? dispatch_fma<true, true>(a, pl, stream)
                : dispatch_fma<true, false>(a, pl, stream);
  return tf32 ? dispatch_fma<false, true>(a, pl, stream)
              : dispatch_fma<false, false>(a, pl, stream);
}

bool plan_ok(int S, int H, const Plan& pl, bool tf32) {
  if (pl.D != 1 && pl.D != 2) return false;
  if (H <= 0 || H % 4 != 0 || pl.P <= 0 || H % pl.P != 0) return false;
  const int Hc = H / pl.P, M = 4 * Hc;
  if (Hc % 4 != 0 || M > kThreads || pl.threads != kThreads) return false;
  if (pl.mma != 0) {
    if (pl.mma != 1 || !tf32 || !MmaSplit(H, pl.P, pl.KS).ok(H, pl.P, pl.KS))
      return false;
  } else if (pl.KS <= 0 || pl.KS > 32 || (pl.KS & (pl.KS - 1)) != 0 ||
             H % (4 * pl.KS) != 0 || M * pl.KS > kThreads) {
    return false;
  }
  if (!(pl.R == 1 || pl.R == 2 || pl.R == 4 || pl.R == kMaxRows)) return false;
  if (!pl.coop && pl.P > 8) return false;
  const int n_blocks = (S + pl.R - 1) / pl.R;
  if (pl.groups <= 0 || pl.groups > n_blocks) return false;
  if (!pl.coop && pl.groups != n_blocks) return false;
  return (size_t)pl.smem ==
         kHeaderBytes + sizeof(float) * smem_floats(pl.R, H, pl.P, pl.coop,
                                                    pl.mma != 0, pl.KS);
}

template <int RT, int NKB>
cudaError_t attributes(bool coop, bool tf32, cudaFuncAttributes* fa) {
  if constexpr (NKB > 0) {
    return coop ? cudaFuncGetAttributes(fa, lstm_kernel<RT, true, true, NKB>)
                : cudaFuncGetAttributes(fa, lstm_kernel<RT, false, true, NKB>);
  } else {
    if (coop)
      return tf32 ? cudaFuncGetAttributes(fa, lstm_kernel<RT, true, true>)
                  : cudaFuncGetAttributes(fa, lstm_kernel<RT, true, false>);
    return tf32 ? cudaFuncGetAttributes(fa, lstm_kernel<RT, false, true>)
                : cudaFuncGetAttributes(fa, lstm_kernel<RT, false, false>);
  }
}

}  // namespace

extern "C" {

// Most groups the card holds at once for a plan of the fp32 (tf32 = 0) or
// the TF32 instantiation: clusters (cudaOccupancyMaxActiveClusters) or,
// cooperative, resident CTAs. A negative value is minus a cudaError_t.
int lstm_max_active(int S, int H, int D, int R, int P, int KS, int groups,
                    int coop, int threads, int smem, int mma, int tf32) {
  const Plan pl{D, R, P, KS, groups, coop, threads, smem, mma};
  if (!plan_ok(S, H, pl, tf32 != 0)) return -(int)cudaErrorInvalidValue;
  return dispatch(nullptr, pl, H, tf32 != 0, nullptr);
}

// Registers a thread and local-memory bytes (spills, stack) of the
// instantiation a plan of (R, coop, tf32; mma: its k-blocks NKB a warp, 0
// for the FMA form) launches, from cudaFuncGetAttributes; returns a
// cudaError_t.
int lstm_func_attributes(int R, int coop, int tf32, int mma_nkb, int* regs,
                         int* local_bytes) {
  cudaFuncAttributes fa = {};
  cudaError_t e;
  if (mma_nkb && !tf32) return (int)cudaErrorInvalidValue;
  switch (mma_nkb ? mma_nkb : -R) {
    case 4: e = attributes<0, 4>(coop, true, &fa); break;
    case 16: e = attributes<0, 16>(coop, true, &fa); break;
    case -1: e = attributes<1, 0>(coop, tf32, &fa); break;
    case -2: e = attributes<2, 0>(coop, tf32, &fa); break;
    case -4: e = attributes<4, 0>(coop, tf32, &fa); break;
    case -8: e = attributes<8, 0>(coop, tf32, &fa); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)e;
}

// Launches the scan on `stream`, the TF32 instantiation when tf32 != 0 (on
// the tensor cores when the plan's mma = 1); returns cudaGetLastError() (0
// on success).
int lstm_forward(const float* u, const float* whh, const float* h0,
                 const float* c0, const int* n_valid, float* y, float* h_out,
                 float* c_out, float* xchg, unsigned* counter, int S, int T,
                 int H, int D, int R, int P, int KS, int groups, int coop,
                 int threads, int smem, int mma, int tf32,
                 cudaStream_t stream) {
  const Plan pl{D, R, P, KS, groups, coop, threads, smem, mma};
  if (S <= 0 || T <= 0 || !plan_ok(S, H, pl, tf32 != 0))
    return (int)cudaErrorInvalidValue;
  if (coop && !(xchg && counter)) return (int)cudaErrorInvalidValue;
  Args a{u, whh, h0, c0, n_valid, y, h_out, c_out, xchg, counter,
         S, T, H, D, P, KS, R};
  return dispatch(&a, pl, H, tf32 != 0, stream);
}

const char* lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

SCAN_PHASE_EXPORT(lstm)
