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
// Per frame, in order (fp32 FMA throughout, no TF32 and no bf16 — the
// numerics of precision="highest"):
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
//     the block is valid only write y.
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
  int S, T, H, D, P, KS;
};

// Floats of dynamic shared memory after the header. W_hh's rows are padded
// by 4 floats: lanes of k-slices 4 rows apart then read different banks.
size_t smem_floats(int R, int H, int P, bool coop) {
  const size_t Hc = H / P, M = 4 * Hc;
  return (size_t)H * (M + 4) + (coop ? 1 : 2) * (size_t)R * H +
         2 * (size_t)R * M + (size_t)R * Hc;
}

template <int R, bool COOP>
__global__ void __launch_bounds__(kThreads, 1) lstm_kernel(Args a) {
  PhaseClock clk(threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
                 blockIdx.z == 0);
  const int p = blockIdx.x;      // cluster rank (cluster dims (P, 1, 1))
  const int d = blockIdx.z;
  const int S = a.S, T = a.T, H = a.H, P = a.P, KS = a.KS, G = 4 * H;
  const size_t YW = (size_t)a.D * H;   // y's row: the D directions' h
  const int Hc = H / P, M = 4 * Hc, WS = M + 4, cpw = 32 / KS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_blocks = (S + R - 1) / R;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int* nv_s = reinterpret_cast<int*>(smem_raw + 16);          // [R]
  float* w_s = reinterpret_cast<float*>(smem_raw + kHeaderBytes);  // [H, WS]
  float* h_buf = w_s + (size_t)H * WS;  // [1 or 2, R, H] full h
  float* z_s = h_buf + (COOP ? 1 : 2) * R * H;   // [R, M] h·W_hh slice
  float* u_s = z_s + R * M;             // [R, M] this frame's u slice
  float* c_s = u_s + R * M;             // [R, Hc] carried c slice

  // the W_hh slice: column block g·H + p·Hc … of every row k
  if (tid == 0) {
    mbar_init(bar);
    mbar_arrive_expect_tx(bar, (uint32_t)(sizeof(float) * H * M));
  }
  __syncthreads();
  const float* whh = a.whh + (size_t)d * H * G;
  for (int e = tid; e < 4 * H; e += kThreads) {
    const int k = e >> 2, g = e & 3;
    bulk_load(w_s + (size_t)k * WS + g * Hc,
              whh + (size_t)k * G + g * H + p * Hc, sizeof(float) * Hc, bar);
  }

  unsigned epoch = 0;       // frames exchanged so far (cooperative counter)
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
    for (int e = tid; e < (COOP ? 1 : 2) * R * H; e += kThreads) {
      const int r = (e / H) % R, k = e % H;
      const bool first = e < R * H;
      h_buf[e] = first && r < rows
                     ? a.h0[((size_t)d * S + s0 + r) * H + k] : 0.0f;
    }
    for (int e = tid; e < R * Hc; e += kThreads) {
      const int r = e / Hc;
      c_s[e] = r < rows ? a.c0[((size_t)d * S + s0 + r) * H + p * Hc +
                               (e - r * Hc)] : 0.0f;
    }
    auto prefetch_u = [&](int step) {
      const int frame = d == 0 ? step : T - 1 - step;
      for (int e = tid; e < rows * (M / 4); e += kThreads) {
        const int r = e / (M / 4), q = e - r * (M / 4);
        const int g = (4 * q) / Hc, j = 4 * q - g * Hc;
        cp_async16(u_s + r * M + 4 * q,
                   a.u + (((size_t)d * S + s0 + r) * T + frame) * G + g * H +
                       p * Hc + j);
      }
      cp_async_commit();
    };
    prefetch_u(0);
    if (sb == (int)blockIdx.y) mbar_wait(bar, 0);
    __syncthreads();
    if constexpr (!COOP) cg::this_cluster().sync();   // peers are running
    clk.mark(16);

    int cur = 0;
    const unsigned block_epoch = epoch;
    for (int step = 0; step < T; ++step) {
      const int frame = d == 0 ? step : T - 1 - step;
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) any |= frame < nv_s[r];
      float* h_cur = h_buf + cur * R * H;

      if (!any) {                 // every stream of the block carries: y = h
        cp_async_wait_all();
        if (step + 1 < T) prefetch_u(step + 1);
        for (int e = tid; e < rows * Hc; e += kThreads) {
          const int r = e / Hc, j = e - r * Hc;
          a.y[((size_t)(s0 + r) * T + frame) * YW + (size_t)d * H +
              p * Hc + j] = h_cur[r * H + p * Hc + j];
        }
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
          for (int e = tid; e < rows * H / 4; e += kThreads)
            reinterpret_cast<float4*>(h_cur)[e] = __ldcg(src + e);
          __syncthreads();
        }
        clk.mark(2);
      }

      // z slice = h·W_hh[:, own columns], all R streams at once; k-slice
      // ks takes the float4 groups k = 4·ks, 4·ks + 4·KS, … so that the
      // slices' broadcast reads of h land in different banks
      if (warp < zwarps) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        const float* wp = w_s + colr;
        const float* hp = h_cur;
        for (int k = 4 * ks; k < H; k += 4 * KS) {
          const float w0 = wp[(k + 0) * WS], w1 = wp[(k + 1) * WS];
          const float w2 = wp[(k + 2) * WS], w3 = wp[(k + 3) * WS];
#pragma unroll
          for (int r = 0; r < R; ++r) {
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
          for (int r = 0; r < R; ++r)
            if (r % KS == ks) z_s[r * M + col] = acc[r];
        }
      }
      clk.mark(3);
      cp_async_wait_all();
      __syncthreads();
      clk.mark(4);

      // the cell, local: unit j of stream r reads its four gate columns
      float* h_new = COOP ? h_cur : h_buf + (cur ^ 1) * R * H;
      for (int e = tid; e < rows * Hc; e += kThreads) {
        const int r = e / Hc, j = e - r * Hc;
        const float* zr = z_s + r * M;
        const float* ur = u_s + r * M;
        float h = h_cur[r * H + p * Hc + j];
        if (frame < nv_s[r]) {
          const float ig = sigmoid_f(ur[j] + zr[j]);
          const float fg = sigmoid_f(ur[Hc + j] + zr[Hc + j]);
          const float gg = tanhf(ur[2 * Hc + j] + zr[2 * Hc + j]);
          const float og = sigmoid_f(ur[3 * Hc + j] + zr[3 * Hc + j]);
          const float c = fg * c_s[e] + ig * gg;
          c_s[e] = c;
          h = og * tanhf(c);
        }
        h_new[r * H + p * Hc + j] = h;
        if constexpr (COOP)
          xg[(size_t)((epoch + 1) & 1) * R * H + r * H + p * Hc + j] = h;
        a.y[((size_t)(s0 + r) * T + frame) * YW + (size_t)d * H + p * Hc +
            j] = h;
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
      } else {
        cg::cluster_group cluster = cg::this_cluster();
        const int q4 = Hc / 4, slice = rows * q4;
        for (int e = tid; e < (P - 1) * slice; e += kThreads) {
          const int k = e / slice, rem = e - k * slice;
          const int peer = k < p ? k : k + 1;
          const int r = rem / q4;
          float* src = h_new + r * H + p * Hc + 4 * (rem - r * q4);
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
      a.h_out[g] = h_buf[cur * R * H + r * H + p * Hc + j];
      a.c_out[g] = c_s[e];
    }
  }
}

struct Plan {
  int D, R, P, KS, groups, coop, threads, smem;
};

template <int R, bool COOP>
int launch(const Args& a, const Plan& pl, cudaStream_t stream) {
  auto kern = lstm_kernel<R, COOP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.P, pl.groups, pl.D);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (COOP) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.P;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int R, bool COOP>
int occupancy(const Plan& pl) {
  auto kern = lstm_kernel<R, COOP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return -(int)err;
  if (COOP) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, pl.smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return err == cudaSuccess ? per_sm * sms : -(int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.P, pl.groups, pl.D);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

template <bool COOP>
int dispatch(const Args* a, const Plan& pl, cudaStream_t stream) {
  switch (pl.R) {
    case 1: return a ? launch<1, COOP>(*a, pl, stream) : occupancy<1, COOP>(pl);
    case 2: return a ? launch<2, COOP>(*a, pl, stream) : occupancy<2, COOP>(pl);
    case 4: return a ? launch<4, COOP>(*a, pl, stream) : occupancy<4, COOP>(pl);
    default:
      return a ? launch<kMaxRows, COOP>(*a, pl, stream)
               : occupancy<kMaxRows, COOP>(pl);
  }
}

bool plan_ok(int S, int H, const Plan& pl) {
  if (pl.D != 1 && pl.D != 2) return false;
  if (H <= 0 || H % 4 != 0 || pl.P <= 0 || H % pl.P != 0) return false;
  const int Hc = H / pl.P, M = 4 * Hc;
  if (Hc % 4 != 0 || M > kThreads || pl.threads != kThreads) return false;
  if (pl.KS <= 0 || pl.KS > 32 || (pl.KS & (pl.KS - 1)) != 0 ||
      H % (4 * pl.KS) != 0 || M * pl.KS > kThreads)
    return false;
  if (!(pl.R == 1 || pl.R == 2 || pl.R == 4 || pl.R == kMaxRows)) return false;
  if (!pl.coop && pl.P > 8) return false;
  const int n_blocks = (S + pl.R - 1) / pl.R;
  if (pl.groups <= 0 || pl.groups > n_blocks) return false;
  if (!pl.coop && pl.groups != n_blocks) return false;
  return (size_t)pl.smem ==
         kHeaderBytes + sizeof(float) * smem_floats(pl.R, H, pl.P, pl.coop);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of a plan, in bytes.
size_t lstm_smem_bytes(int R, int H, int P, int coop) {
  if (H <= 0 || P <= 0 || H % P != 0) return 0;
  return kHeaderBytes + sizeof(float) * smem_floats(R, H, P, coop != 0);
}

// Most groups the card holds at once for a plan: clusters
// (cudaOccupancyMaxActiveClusters) or, cooperative, resident CTAs. A
// negative value is minus a cudaError_t.
int lstm_max_active(int S, int H, int D, int R, int P, int KS, int groups,
                    int coop, int threads, int smem) {
  const Plan pl{D, R, P, KS, groups, coop, threads, smem};
  if (!plan_ok(S, H, pl)) return -(int)cudaErrorInvalidValue;
  return coop ? dispatch<true>(nullptr, pl, nullptr)
              : dispatch<false>(nullptr, pl, nullptr);
}

// Launches the scan on `stream`; returns cudaGetLastError() (0 on success).
int lstm_forward(const float* u, const float* whh, const float* h0,
                 const float* c0, const int* n_valid, float* y, float* h_out,
                 float* c_out, float* xchg, unsigned* counter, int S, int T,
                 int H, int D, int R, int P, int KS, int groups, int coop,
                 int threads, int smem, cudaStream_t stream) {
  const Plan pl{D, R, P, KS, groups, coop, threads, smem};
  if (S <= 0 || T <= 0 || !plan_ok(S, H, pl))
    return (int)cudaErrorInvalidValue;
  if (coop && !(xchg && counter)) return (int)cudaErrorInvalidValue;
  Args a{u, whh, h0, c0, n_valid, y, h_out, c_out, xchg, counter,
         S, T, H, D, P, KS};
  return coop ? dispatch<true>(&a, pl, stream)
              : dispatch<false>(&a, pl, stream);
}

const char* lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

SCAN_PHASE_EXPORT(lstm)
