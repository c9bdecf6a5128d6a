// Bidirectional dense LSTM scan (the DIP / TransPose layers) for Hopper,
// sm_90a.
//
// Replaces _lstm_kernel (a3gc_tpu/ops/pallas_gcn_lstm.py:580), which
// lstm_scan_pallas launches once per direction over B rows with ONE scalar
// n_valid for all of them. Here one launch runs both directions, and the
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
// Work split: grid = (stream blocks of R ≤ 8 streams, 2 directions). Thread
// j owns hidden unit j of every stream of its block: it accumulates the
// four gate columns j, H+j, 2H+j, 3H+j of h·W_hh for the R rows at once,
// so each W_hh element it reads from L2 serves R streams, and the cell
// update needs no exchange. h is double-buffered in shared memory (every
// thread reads all of it), c stays in shared memory column-private: one
// barrier per frame. 48 KB of shared memory at H = 512, R = 8.
//
// Layouts (all contiguous fp32 unless noted):
//   u [2, S, T, 4H]   W_hh [2, H, 4H]   h0, c0, h_out, c_out [2, S, H]
//   n_valid [S] int32   y [S, T, 2H]
//
// What bounds it on the card: 8·H² FLOP per frame, stream and direction,
// sequential over frames. W_hh is 1 MiB per direction at H = 256 and
// 4 MiB at H = 512, so it streams from L2 every frame; with 2·⌈S/8⌉ CTAs a
// frame costs one SM's FMA and L2 time for the whole block. Later PRs:
// split W_hh's columns over a thread-block cluster so that it stays in
// shared memory, exchanging h through distributed shared memory each frame,
// then tensor cores for h·W_hh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (a3gc_tpu_torch/ops/_build.py); bound to PyTorch
// with ctypes (a3gc_tpu_torch/ops/lstm.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxRows = 8;      // streams per CTA
constexpr int kMaxThreads = 512;

struct Args {
  const float* u;
  const float* whh;
  const float* h0;
  const float* c0;
  const int* n_valid;
  float* y;
  float* h_out;
  float* c_out;
  int S, T, H;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads) lstm_kernel(Args a) {
  const int s0 = blockIdx.x * R;
  const int d = blockIdx.y;
  const int S = a.S, T = a.T, H = a.H, G = 4 * H;
  const int rows = S - s0 < R ? S - s0 : R;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  extern __shared__ __align__(16) float smem[];
  float* h_cur = smem;             // [R, H] carried h, read by every thread
  float* h_nxt = h_cur + R * H;    // [R, H] written this frame
  float* c_s = h_nxt + R * H;      // [R, H] carried c, column-private

  const float* whh = a.whh + (size_t)d * H * G;
  int nv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) nv[r] = r < rows ? a.n_valid[s0 + r] : 0;

  for (int e = tid; e < R * H; e += nthreads) {
    const int r = e / H;
    const size_t g = ((size_t)d * S + s0 + r) * H + (e - r * H);
    h_cur[e] = r < rows ? a.h0[g] : 0.0f;
    c_s[e] = r < rows ? a.c0[g] : 0.0f;
  }
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int frame = d == 0 ? step : T - 1 - step;
    for (int j = tid; j < H; j += nthreads) {
      float zi[R], zf[R], zg[R], zo[R];
#pragma unroll
      for (int r = 0; r < R; ++r) zi[r] = zf[r] = zg[r] = zo[r] = 0.0f;
      const float* w = whh + j;
      for (int k = 0; k < H; k += 4) {
        float wi[4], wf[4], wg[4], wo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* row = w + (size_t)(k + q) * G;
          wi[q] = __ldg(row);
          wf[q] = __ldg(row + H);
          wg[q] = __ldg(row + 2 * H);
          wo[q] = __ldg(row + 3 * H);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(h_cur + r * H + k);
          zi[r] = fmaf(hv.x, wi[0], zi[r]);
          zi[r] = fmaf(hv.y, wi[1], zi[r]);
          zi[r] = fmaf(hv.z, wi[2], zi[r]);
          zi[r] = fmaf(hv.w, wi[3], zi[r]);
          zf[r] = fmaf(hv.x, wf[0], zf[r]);
          zf[r] = fmaf(hv.y, wf[1], zf[r]);
          zf[r] = fmaf(hv.z, wf[2], zf[r]);
          zf[r] = fmaf(hv.w, wf[3], zf[r]);
          zg[r] = fmaf(hv.x, wg[0], zg[r]);
          zg[r] = fmaf(hv.y, wg[1], zg[r]);
          zg[r] = fmaf(hv.z, wg[2], zg[r]);
          zg[r] = fmaf(hv.w, wg[3], zg[r]);
          zo[r] = fmaf(hv.x, wo[0], zo[r]);
          zo[r] = fmaf(hv.y, wo[1], zo[r]);
          zo[r] = fmaf(hv.z, wo[2], zo[r]);
          zo[r] = fmaf(hv.w, wo[3], zo[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          const int s = s0 + r;
          const float* u_t = a.u + (((size_t)d * S + s) * T + frame) * G;
          const float ig = sigmoid_f(u_t[j] + zi[r]);
          const float fg = sigmoid_f(u_t[H + j] + zf[r]);
          const float gg = tanhf(u_t[2 * H + j] + zg[r]);
          const float og = sigmoid_f(u_t[3 * H + j] + zo[r]);
          float h = h_cur[r * H + j];
          if (frame < nv[r]) {
            const float c = fg * c_s[r * H + j] + ig * gg;
            c_s[r * H + j] = c;
            h = og * tanhf(c);
          }
          h_nxt[r * H + j] = h;
          a.y[((size_t)s * T + frame) * 2 * H + (size_t)d * H + j] = h;
        }
      }
    }
    __syncthreads();
    float* t = h_cur;
    h_cur = h_nxt;
    h_nxt = t;
  }

  for (int e = tid; e < rows * H; e += nthreads) {
    const int r = e / H;
    const size_t g = ((size_t)d * S + s0 + r) * H + (e - r * H);
    a.h_out[g] = h_cur[e];
    a.c_out[g] = c_s[e];
  }
}

template <int R>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)3 * R * a.H;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((a.H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  lstm_kernel<R><<<dim3((a.S + R - 1) / R, 2), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Streams per CTA: the least power of two >= min(S, 8).
int lstm_rows_per_cta(int S) {
  return S <= 1 ? 1 : S <= 2 ? 2 : S <= 4 ? 4 : kMaxRows;
}

// Dynamic shared memory of one CTA at S streams, in bytes.
size_t lstm_smem_bytes(int S, int H) {
  return sizeof(float) * (size_t)3 * lstm_rows_per_cta(S) * H;
}

// Launches the scan on `stream`; returns cudaGetLastError() (0 on success).
int lstm_forward(const float* u, const float* whh, const float* h0,
                 const float* c0, const int* n_valid, float* y, float* h_out,
                 float* c_out, int S, int T, int H, cudaStream_t stream) {
  if (S <= 0 || T <= 0 || H <= 0 || H % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{u, whh, h0, c0, n_valid, y, h_out, c_out, S, T, H};
  switch (lstm_rows_per_cta(S)) {
    case 1: return launch<1>(a, stream);
    case 2: return launch<2>(a, stream);
    case 4: return launch<4>(a, stream);
    default: return launch<kMaxRows>(a, stream);
  }
}

const char* lstm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
