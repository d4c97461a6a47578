// Reverse-time LSTM backward with the per-row burn-in seam, for Hopper
// (sm_90a), float32.
//
// Replaces the TPU kernel `_seq_bwd_kernel` / `_lstm_seq_bwd_call` of
// r2d2_tpu/ops/pallas_lstm.py. Walking t from T-1 down to 0, for each row b
// with seam burn[b]:
//     keep       = t >= burn[b]   (else the step's output cotangent is 0)
//     carry_keep = t >  burn[b]   (else the (dh, dc) carry into t-1 is cut)
// the step's gates are recomputed from the saved h_{t-1} (hprev), c_{t-1}
// (cprev) and c_t (cs), the pre-activation gradient dz[t] (4H wide, i,f,g,o
// order) is written out, and the carry moves on as dh = dz @ wh^T,
// dc = dc * f. dWh = hprev^T @ dz is NOT computed here: it is one large
// matmul outside the kernel, as the JAX package leaves it to XLA.
//
// What bounds it on this card. Each (row, step) does two H x 4H products:
// the gate recompute and the carry. At the atari widths that is about
// 22.8 GFLOP against about 140 MB of device-memory traffic, so the least
// time is set by the fp32 rate. As in the forward kernel, wh (and here also
// wh^T) is 4 MiB each at H=512: it stays in L2, not in shared memory.
//
// What the design does about it. The forward kernel's row-tile layout: a
// block owns kRows batch rows for the whole reverse walk, so rows never
// synchronise across blocks. A thread owns hidden unit j. The recompute
// reads wh column-wise (neighbouring threads, neighbouring addresses). The
// carry dh[j] = sum_m dz[m] * wh[j, m] needs each row's whole 4H-wide dz,
// so dz is staged in shared memory behind a block barrier and the product
// reads the contiguous wh^T that the wrapper makes once per call, again
// coalesced across j. Every wh / wh^T value loaded feeds kRows FMAs.
// Ragged B and any H are masked.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;       // batch rows per block
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void lstm_seq_bwd_kernel(const float* __restrict__ dout,   // (T, B, H)
                                    const float* __restrict__ proj,   // (T, B, 4H)
                                    const float* __restrict__ hprev,  // (T, B, H)
                                    const float* __restrict__ cprev,  // (T, B, H)
                                    const float* __restrict__ cs,     // (T, B, H)
                                    const float* __restrict__ wh,     // (H, 4H)
                                    const float* __restrict__ whT,    // (4H, H)
                                    const float* __restrict__ dcT,    // (B, H)
                                    const int* __restrict__ burn,     // (B,)
                                    float* __restrict__ dz,           // (T, B, 4H)
                                    int T, int B, int H) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  float* h_s = smem;                // kRows * H:  h_{t-1} of the tile
  float* dz_s = h_s + kRows * H;    // kRows * 4H: this step's dz
  float* dh_s = dz_s + kRows * H4;  // kRows * H:  dh carry
  float* dc_s = dh_s + kRows * H;   // kRows * H:  dc carry
  const int row0 = blockIdx.x * kRows;

  int seam[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // a padding row never keeps a cotangent nor a carry
    seam[r] = (row0 + r < B) ? burn[row0 + r] : T;
  }
  for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
    const int r = idx / H, j = idx - r * H, row = row0 + r;
    dh_s[idx] = 0.0f;  // the h_T cotangent is folded into dout[T-1]
    dc_s[idx] = (row < B) ? dcT[(size_t)row * H + j] : 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
      const int r = idx / H, j = idx - r * H, row = row0 + r;
      h_s[idx] = (row < B) ? hprev[((size_t)t * B + row) * H + j] : 0.0f;
    }
    // also orders the previous step's carry reads of dz_s before the
    // writes below
    __syncthreads();

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
          const float hk = h_s[r * H + k];
          acc[r][0] = fmaf(hk, w0, acc[r][0]);
          acc[r][1] = fmaf(hk, w1, acc[r][1]);
          acc[r][2] = fmaf(hk, w2, acc[r][2]);
          acc[r][3] = fmaf(hk, w3, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float* zs = dz_s + r * H4 + j;
        const int row = row0 + r;
        if (row >= B) {
          zs[0] = zs[H] = zs[2 * H] = zs[3 * H] = 0.0f;
          continue;
        }
        const size_t o1 = ((size_t)t * B + row) * H + j;
        const size_t o4 = ((size_t)t * B + row) * H4 + j;
        const float* p = proj + o4;
        const float ig = sigmoid_f32(p[0] + acc[r][0]);
        const float fg = sigmoid_f32(p[H] + acc[r][1]);
        const float gg = tanhf(p[2 * H] + acc[r][2]);
        const float og = sigmoid_f32(p[3 * H] + acc[r][3]);
        const float tc = tanhf(cs[o1]);
        const float dh = (t >= seam[r] ? dout[o1] : 0.0f) + dh_s[r * H + j];
        const float d_o = dh * tc;
        const float dc = dh * og * (1.0f - tc * tc) + dc_s[r * H + j];
        const float di = dc * gg;
        const float df = dc * cprev[o1];
        const float dg = dc * ig;
        const float zi = di * ig * (1.0f - ig);
        const float zf = df * fg * (1.0f - fg);
        const float zg = dg * (1.0f - gg * gg);
        const float zo = d_o * og * (1.0f - og);
        float* out = dz + o4;
        out[0] = zi;
        out[H] = zf;
        out[2 * H] = zg;
        out[3 * H] = zo;
        zs[0] = zi;
        zs[H] = zf;
        zs[2 * H] = zg;
        zs[3 * H] = zo;
        dc_s[r * H + j] = (t > seam[r]) ? dc * fg : 0.0f;
      }
    }
    __syncthreads();  // the whole dz row is staged

    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      const float* w = whT + j;
#pragma unroll 4
      for (int m = 0; m < H4; ++m) {
        const float wm = __ldg(w + (size_t)m * H);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(dz_s[r * H4 + m], wm, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dh_s[r * H + j] = (t > seam[r]) ? acc[r] : 0.0f;
    }
  }
}

}  // namespace

extern "C" int lstm_seq_bwd_launch(const float* dout, const float* proj,
                                   const float* hprev, const float* cprev,
                                   const float* cs, const float* wh,
                                   const float* whT, const float* dcT,
                                   const int* burn, float* dz, int T, int B,
                                   int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int threads = ((H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = 7 * (size_t)kRows * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_seq_bwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      dout, proj, hprev, cprev, cs, wh, whT, dcT, burn, dz, T, B, H);
  return (int)cudaGetLastError();
}

extern "C" const char* lstm_seq_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
