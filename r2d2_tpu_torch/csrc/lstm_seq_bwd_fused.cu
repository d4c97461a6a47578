// Reverse-time LSTM backward with the per-row burn-in seam and the
// recurrent-weight gradient accumulated in the kernel, for Hopper (sm_90a),
// float32.
//
// Replaces the TPU kernel `_seq_bwd_fused_kernel` /
// `_lstm_seq_bwd_fused_call` of r2d2_tpu/ops/pallas_lstm.py (the fused_dwh
// backward arm). The reverse walk is the seam walk of lstm_seq_bwd.cu:
// keep = t >= burn[b] masks the step's output cotangent, carry_keep =
// t > burn[b] cuts the (dh, dc) carry into t-1, dz[t] is written out.
// On top of it, every step adds h_{t-1}^T @ dz_t into dWh (H, 4H), so no
// matmul over (T*B) is left outside the kernel.
//
// What bounds it on this card. The walk's two H x 4H products per (row,
// step) plus the dWh update, another 2*H*4H per kept (row, step): at the
// atari widths about 34 GFLOP of fp32 work against about 150 MB that the
// function must move, so the least time is set by the fp32 rate.
//
// What the design does about it. The TPU kernel keeps dWh in VMEM for the
// whole walk; here dWh is 4 MiB at H=512 (64 MiB at H=2048), far past a
// block's shared memory, and 16 blocks (at B=64) each add into it. Float
// atomics from every block on every step would be about 1.4e9 of them per
// launch, and their order would change from run to run. Instead each block
// owns a dWh partial in a workspace the wrapper allocates (blocks x H x 4H
// floats): thread j adds sum_r h[r,k] * dz[r, g*H+j] into columns g*H+j
// of every row k, coalesced across j, with nothing to race. Steps where
// every row of the tile is below its seam have dz = 0 and skip the update.
// The partials are summed inside the same launch: each block fences its
// writes and takes a ticket with one integer atomic, and the block that
// takes the last ticket adds the partials in block order. One launch, and
// dWh is the same bits on every run. dz is formed in a row-tile layout
// that sums in another order than lstm_seq_bwd.cu's column split, so the
// two agree to rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;       // batch rows per block
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// dWh[k, g*H+j] += sum_r h[r, k] * d[r][g] for every k, into this block's
// partial. All loads of kK rows are issued before any store: the compiler
// cannot tell the partial's loads from its stores apart, so a plain loop
// would wait one memory round trip per element.
constexpr int kK = 4;

__device__ __forceinline__ void add_dwh(float* part, const float* h_s,
                                        const float (&d)[kRows][4], int j, int H) {
  const int H4 = 4 * H;
  for (int k0 = 0; k0 < H; k0 += kK) {
    float a[kK][4];
#pragma unroll
    for (int u = 0; u < kK; ++u) {
      const float* pk = part + (size_t)(k0 + u) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) a[u][g] = (k0 + u < H) ? pk[g * H] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kK; ++u) {
      if (k0 + u >= H) break;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hk = h_s[r * H + k0 + u];
#pragma unroll
        for (int g = 0; g < 4; ++g) a[u][g] = fmaf(hk, d[r][g], a[u][g]);
      }
      float* pk = part + (size_t)(k0 + u) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) pk[g * H] = a[u][g];
    }
  }
}

// at most kMaxThreads threads: the compiler keeps each under 65536 / 512 = 128
// registers, so a full block fits one SM's register file
__global__ void __launch_bounds__(kMaxThreads)
lstm_seq_bwd_fused_kernel(const float* __restrict__ dout,   // (T, B, H)
                          const float* __restrict__ proj,   // (T, B, 4H)
                          const float* __restrict__ hprev,  // (T, B, H)
                          const float* __restrict__ cprev,  // (T, B, H)
                          const float* __restrict__ cs,     // (T, B, H)
                          const float* __restrict__ wh,     // (H, 4H)
                          const float* __restrict__ whT,    // (4H, H)
                          const float* __restrict__ dcT,    // (B, H)
                          const int* __restrict__ burn,     // (B,)
                          float* __restrict__ dz,           // (T, B, 4H)
                          float* __restrict__ dwh,          // (H, 4H)
                          float* part,   // (blocks, H, 4H) workspace
                          int* ticket,   // 1 int, zero at launch
                          int T, int B, int H) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  float* h_s = smem;                // kRows * H:  h_{t-1} of the tile
  float* dz_s = h_s + kRows * H;    // kRows * 4H: this step's dz
  float* dh_s = dz_s + kRows * H4;  // kRows * H:  dh carry
  float* dc_s = dh_s + kRows * H;   // kRows * H:  dc carry
  float* last_s = dc_s + kRows * H; // 1: whether this block finished last
  const int row0 = blockIdx.x * kRows;
  const int blocks = (B + kRows - 1) / kRows;
  const size_t wsize = (size_t)H * H4;
  float* mine = part + blockIdx.x * wsize;

  int seam[kRows];
  int tile_seam = T;  // the tile's first step with a nonzero dz
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // a padding row never keeps a cotangent nor a carry
    seam[r] = (row0 + r < B) ? burn[row0 + r] : T;
    tile_seam = seam[r] < tile_seam ? seam[r] : tile_seam;
  }
  for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
    const int r = idx / H, j = idx - r * H, row = row0 + r;
    dh_s[idx] = 0.0f;  // the h_T cotangent is folded into dout[T-1]
    dc_s[idx] = (row < B) ? dcT[(size_t)row * H + j] : 0.0f;
  }
  // the partial is zeroed by the threads that later add into it
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    for (int k = 0; k < H; ++k) {
      float* pk = mine + (size_t)k * H4 + j;
      pk[0] = pk[H] = pk[2 * H] = pk[3 * H] = 0.0f;
    }
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
      float d[kRows][4];  // this step's dz of unit j, for the dWh update
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float* zs = dz_s + r * H4 + j;
        const int row = row0 + r;
        if (row >= B) {
          zs[0] = zs[H] = zs[2 * H] = zs[3 * H] = 0.0f;
          d[r][0] = d[r][1] = d[r][2] = d[r][3] = 0.0f;
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
        d[r][0] = zi;
        d[r][1] = zf;
        d[r][2] = zg;
        d[r][3] = zo;
        dc_s[r * H + j] = (t > seam[r]) ? dc * fg : 0.0f;
      }
      if (t >= tile_seam) add_dwh(mine, h_s, d, j, H);
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

  // the block that finishes last sums the partials, in block order
  __threadfence();  // this thread's partial writes, before the ticket
  __syncthreads();
  if (threadIdx.x == 0) last_s[0] = (atomicAdd(ticket, 1) == blocks - 1) ? 1.0f : 0.0f;
  __syncthreads();
  if (last_s[0] != 0.0f) {
    __threadfence();
    const volatile float* all = part;  // written by other blocks: no stale cache
    for (size_t i = threadIdx.x; i < wsize; i += blockDim.x) {
      float s = 0.0f;
      for (int b = 0; b < blocks; ++b) s += all[b * wsize + i];
      dwh[i] = s;
    }
  }
}

}  // namespace

extern "C" int lstm_seq_bwd_fused_launch(const float* dout, const float* proj,
                                         const float* hprev, const float* cprev,
                                         const float* cs, const float* wh,
                                         const float* whT, const float* dcT,
                                         const int* burn, float* dz, float* dwh,
                                         float* part, int* ticket, int T, int B,
                                         int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int threads = ((H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (7 * (size_t)kRows * H + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lstm_seq_bwd_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_seq_bwd_fused_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      dout, proj, hprev, cprev, cs, wh, whT, dcT, burn, dz, dwh, part, ticket, T, B, H);
  return (int)cudaGetLastError();
}

extern "C" const char* lstm_seq_bwd_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
