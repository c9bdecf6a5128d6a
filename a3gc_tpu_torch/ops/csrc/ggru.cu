// Bidirectional G-GRU scan for Hopper, sm_90a.
//
// Replaces _ggru_kernel (a3gc_tpu/ops/pallas_gcn_lstm.py:412), which
// ggru_scan_pallas launches once per direction over R = B*15 rows, the B
// streams folded onto the rows with a block-diagonal adjacency per 128-row
// MXU tile, padded to 8 streams, and per-stream validity broadcast onto the
// rows through a membership matrix. None of that survives here: grid =
// (S streams, 2 directions), one CTA each, both directions in one launch,
// and every CTA walks all T frames of its (stream, direction) with the
// stream's 15 node rows as its own.
//
// Per frame, in order (the JAX cell's op order, fp32 FMA throughout, no TF32
// and no bf16 — the numerics of precision="highest"):
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
// Work split: thread k owns hidden column k. It computes column k of h·G
// for every node (so the graph mix adj·(h·G) needs no exchange between
// threads), writes msg's column k, and after one barrier computes the three
// gate columns k, H+k, 2H+k of msg·W_hid for every node, then the GRU
// update of h[:, k] in registers. Two barriers per frame. Shared memory
// holds h and msg, 16 padded node rows each, and the adjacency padded to
// 16 × 16 (zero rows and columns past N), 33 KB at H = 256.
//
// Layouts (all contiguous fp32 unless noted):
//   zi [2, S, T, N, 3H]   G [2, H, H]   adj [2, N, N]   W_hid [2, H, 3H]
//   h0, h_out [2, S, N, H]   n_valid [S] int32   y [S, T, N, 2H]
//
// What bounds it on the card: 8·N·H² + 2·N²·H FLOP per frame, stream and
// direction, sequential over frames. Against the fp32 non-tensor peak the
// three serving launches are compute-bound, yet one CTA per (stream,
// direction) uses 2·S of 132 SMs and re-reads G and W_hid (1 MiB at
// H = 256, L2-resident) every frame, so a frame costs the latency of one
// SM's dot loops. Later PRs: split the columns over a thread-block cluster
// with h exchanged through distributed shared memory, then tensor cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (a3gc_tpu_torch/ops/_build.py); bound to PyTorch
// with ctypes (a3gc_tpu_torch/ops/ggru.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxNodes = 16;    // node rows per CTA; rows >= N stay zero
constexpr int kMaxThreads = 512;

struct Args {
  const float* zi;
  const float* gk;
  const float* adj;
  const float* whid;
  const float* h0;
  const int* n_valid;
  float* y;
  float* h_out;
  int S, T, N, H;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads) ggru_kernel(Args a) {
  const int s = blockIdx.x;
  const int d = blockIdx.y;
  const int S = a.S, T = a.T, N = a.N, H = a.H, G3 = 3 * H;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rowsH = kMaxNodes * H;

  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                 // [kMaxNodes, H] carried h
  float* msg_s = h_s + rowsH;        // [kMaxNodes, H] adj·(h·G)
  float* adj_s = msg_s + rowsH;      // [kMaxNodes, kMaxNodes], zero padded

  const float* gk = a.gk + (size_t)d * H * H;
  const float* whid = a.whid + (size_t)d * H * G3;
  const float* adj = a.adj + (size_t)d * N * N;
  const float* zi = a.zi + ((size_t)d * S + s) * T * N * G3;
  const size_t st = ((size_t)d * S + s) * N * H;
  const int nv = a.n_valid[s];

  for (int e = tid; e < rowsH; e += nthreads) {
    h_s[e] = e < N * H ? a.h0[st + e] : 0.0f;
    msg_s[e] = 0.0f;
  }
  for (int e = tid; e < kMaxNodes * kMaxNodes; e += nthreads) {
    const int n = e / kMaxNodes, m = e - n * kMaxNodes;
    adj_s[e] = (n < N && m < N) ? adj[n * N + m] : 0.0f;
  }
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int frame = d == 0 ? step : T - 1 - step;

    // msg[:, k] = adj · (h·G)[:, k]
    for (int k = tid; k < H; k += nthreads) {
      float hg[kMaxNodes];
#pragma unroll
      for (int n = 0; n < kMaxNodes; ++n) hg[n] = 0.0f;
      const float* w = gk + k;
      for (int j = 0; j < H; j += 4) {
        const float w0 = __ldg(w + (size_t)(j + 0) * H);
        const float w1 = __ldg(w + (size_t)(j + 1) * H);
        const float w2 = __ldg(w + (size_t)(j + 2) * H);
        const float w3 = __ldg(w + (size_t)(j + 3) * H);
#pragma unroll
        for (int n = 0; n < kMaxNodes; ++n) {
          const float4 hv = *reinterpret_cast<const float4*>(h_s + n * H + j);
          hg[n] = fmaf(hv.x, w0, hg[n]);
          hg[n] = fmaf(hv.y, w1, hg[n]);
          hg[n] = fmaf(hv.z, w2, hg[n]);
          hg[n] = fmaf(hv.w, w3, hg[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kMaxNodes; ++n) {
        float m = 0.0f;
#pragma unroll
        for (int mm = 0; mm < kMaxNodes; ++mm)
          m = fmaf(adj_s[n * kMaxNodes + mm], hg[mm], m);
        msg_s[n * H + k] = m;     // rows >= N: zero adjacency rows give 0
      }
    }
    __syncthreads();

    // zh = msg·W_hid for gate columns k, H+k, 2H+k; then the GRU update of
    // h[:, k]. Only this thread reads or writes column k of h_s here.
    const float* zi_t = zi + (size_t)frame * N * G3;
    const bool valid = frame < nv;
    float* y_t = a.y + ((size_t)s * T + frame) * N * 2 * H + (size_t)d * H;
    for (int k = tid; k < H; k += nthreads) {
      float zr[kMaxNodes], zu[kMaxNodes], zc[kMaxNodes];
#pragma unroll
      for (int n = 0; n < kMaxNodes; ++n) zr[n] = zu[n] = zc[n] = 0.0f;
      const float* w = whid + k;
      for (int j = 0; j < H; j += 4) {
        float wr[4], wu[4], wc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* row = w + (size_t)(j + q) * G3;
          wr[q] = __ldg(row);
          wu[q] = __ldg(row + H);
          wc[q] = __ldg(row + 2 * H);
        }
#pragma unroll
        for (int n = 0; n < kMaxNodes; ++n) {
          const float4 mv =
              *reinterpret_cast<const float4*>(msg_s + n * H + j);
          zr[n] = fmaf(mv.x, wr[0], zr[n]);
          zr[n] = fmaf(mv.y, wr[1], zr[n]);
          zr[n] = fmaf(mv.z, wr[2], zr[n]);
          zr[n] = fmaf(mv.w, wr[3], zr[n]);
          zu[n] = fmaf(mv.x, wu[0], zu[n]);
          zu[n] = fmaf(mv.y, wu[1], zu[n]);
          zu[n] = fmaf(mv.z, wu[2], zu[n]);
          zu[n] = fmaf(mv.w, wu[3], zu[n]);
          zc[n] = fmaf(mv.x, wc[0], zc[n]);
          zc[n] = fmaf(mv.y, wc[1], zc[n]);
          zc[n] = fmaf(mv.z, wc[2], zc[n]);
          zc[n] = fmaf(mv.w, wc[3], zc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kMaxNodes; ++n) {
        if (n < N) {
          const float* z = zi_t + (size_t)n * G3;
          const float r = sigmoid_f(z[k] + zr[n]);
          const float u = sigmoid_f(z[H + k] + zu[n]);
          const float cand = tanhf(z[2 * H + k] + r * zc[n]);
          float h = h_s[n * H + k];
          if (valid) {
            h = u * h + (1.0f - u) * cand;
            h_s[n * H + k] = h;
          }
          y_t[(size_t)n * 2 * H + k] = h;
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < N * H; e += nthreads) a.h_out[st + e] = h_s[e];
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes.
size_t ggru_smem_bytes(int H) {
  return sizeof(float) *
         ((size_t)2 * kMaxNodes * H + (size_t)kMaxNodes * kMaxNodes);
}

// Launches the scan on `stream`; returns cudaGetLastError() (0 on success).
int ggru_forward(const float* zi, const float* gk, const float* adj,
                 const float* whid, const float* h0, const int* n_valid,
                 float* y, float* h_out, int S, int T, int N, int H,
                 cudaStream_t stream) {
  if (S <= 0 || T <= 0 || N <= 0 || N > kMaxNodes || H <= 0 || H % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ggru_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      ggru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  Args a{zi, gk, adj, whid, h0, n_valid, y, h_out, S, T, N, H};
  ggru_kernel<<<dim3(S, 2), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

const char* ggru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
