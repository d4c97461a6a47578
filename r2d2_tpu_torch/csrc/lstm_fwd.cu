// Fused T-step LSTM forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `_fwd_kernel` / `_lstm_fwd_call` of
// r2d2_tpu/ops/pallas_lstm.py. Per step t, for every batch row:
//     z = proj_t[t] + h_{t-1} @ wh        (f32 accumulate)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of z's four H-wide slices
//     c_t = f * c_{t-1} + i * g;   h_t = o * tanh(c_t)
// writing outs[t] = h_t and cs[t] = c_t. The (h, c) carry stays in f32.
//
// What bounds it on this card. The work is 2*T*B*H*4H FMA-flops of a
// strictly sequential recurrence; at the atari widths (T=85, B=64, H=512)
// that is 11.4 GFLOP against about 71 MB of device-memory traffic, so the
// least possible time is set by the fp32 rate, not by HBM. The TPU kernel
// pins wh (H, 4H) in VMEM for all T steps; at H=512 in f32 that is 4 MiB,
// which no block's shared memory (227 KB) can hold, but the 50 MB L2 can.
//
// What the design does about it. Batch rows are independent, so each block
// owns a tile of kRows rows and walks all T steps inside one launch: no
// cross-block synchronisation, one __syncthreads per step. The tile's h
// lives in shared memory (double-buffered, read as broadcasts) and c in
// shared memory. A thread owns hidden unit j and computes its four gate dot
// products (columns j, H+j, 2H+j, 3H+j) for all kRows rows, so for a fixed
// k neighbouring threads read neighbouring wh addresses (coalesced) and each
// wh value loaded from L2 feeds kRows FMAs. The price of this simple shape:
// every block re-reads all of wh from L2 on every step, and at B=64 only
// B/kRows blocks work. Splitting the 4H columns across a cluster with a
// per-step h exchange is the later, faster design (ROADMAP.md Queue 2).
// Ragged B (not a multiple of kRows) and any H are masked.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;       // batch rows per block
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void lstm_fwd_kernel(const float* __restrict__ proj,  // (T, B, 4H)
                                const float* __restrict__ wh,    // (H, 4H)
                                const float* __restrict__ h0,    // (B, H)
                                const float* __restrict__ c0,    // (B, H)
                                float* __restrict__ outs,        // (T, B, H)
                                float* __restrict__ cs,          // (T, B, H)
                                int T, int B, int H) {
  extern __shared__ float smem[];
  float* h_cur = smem;                // kRows * H: h_{t-1}
  float* h_nxt = smem + kRows * H;    // kRows * H: h_t
  float* c_s = smem + 2 * kRows * H;  // kRows * H: c carry
  const int row0 = blockIdx.x * kRows;
  const int H4 = 4 * H;

  for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
    const int r = idx / H, j = idx - r * H, row = row0 + r;
    const bool ok = row < B;
    h_cur[idx] = ok ? h0[(size_t)row * H + j] : 0.0f;
    h_nxt[idx] = 0.0f;
    c_s[idx] = ok ? c0[(size_t)row * H + j] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
      }
      const float* w = wh + j;
      // several k in flight: each iteration waits on four L2 loads
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float* wk = w + (size_t)k * H4;
        const float w0 = __ldg(wk), w1 = __ldg(wk + H);
        const float w2 = __ldg(wk + 2 * H), w3 = __ldg(wk + 3 * H);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hk = h_cur[r * H + k];
          acc[r][0] = fmaf(hk, w0, acc[r][0]);
          acc[r][1] = fmaf(hk, w1, acc[r][1]);
          acc[r][2] = fmaf(hk, w2, acc[r][2]);
          acc[r][3] = fmaf(hk, w3, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = row0 + r;
        if (row >= B) continue;
        const float* p = proj + ((size_t)t * B + row) * H4 + j;
        const float ig = sigmoid_f32(p[0] + acc[r][0]);
        const float fg = sigmoid_f32(p[H] + acc[r][1]);
        const float gg = tanhf(p[2 * H] + acc[r][2]);
        const float og = sigmoid_f32(p[3 * H] + acc[r][3]);
        const float c = fg * c_s[r * H + j] + ig * gg;
        const float h = og * tanhf(c);
        c_s[r * H + j] = c;
        h_nxt[r * H + j] = h;
        const size_t off = ((size_t)t * B + row) * H + j;
        outs[off] = h;
        cs[off] = c;
      }
    }
    __syncthreads();  // h_t complete before anyone reads it as h_{t-1}
    float* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }
}

}  // namespace

extern "C" int lstm_fwd_launch(const float* proj, const float* wh,
                               const float* h0, const float* c0, float* outs,
                               float* cs, int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int threads = ((H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = 3 * (size_t)kRows * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_fwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      proj, wh, h0, c0, outs, cs, T, B, H);
  return (int)cudaGetLastError();
}

extern "C" const char* lstm_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
