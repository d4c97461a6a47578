// Gradient-checkpointed LSTM backward with the per-row burn-in seam and the
// recurrent-weight gradient accumulated in the kernel, for Hopper (sm_90a),
// float32.
//
// Replaces the TPU kernel `_seq_bwd_ckpt_kernel` / `_lstm_seq_bwd_ckpt_call`
// of r2d2_tpu/ops/pallas_lstm.py (the ckpt backward arm). The forward saved
// only the (h, c) carries entering each S-step segment, h_ckpt / c_ckpt
// (N = T/S, B, H). Per segment, newest first:
//   1. the segment's forward is recomputed from its checkpoint, with the
//      forward's per-step arithmetic, into a (S+1, B, H)
//      h and c scratch;
//   2. the segment is walked in reverse as lstm_seq_bwd_fused.cu walks,
//      the masks keep = t >= burn[b] and carry_keep =
//      t > burn[b] on the real step t = seg*S + s, writing dz[t] and adding
//      h_{t-1}^T @ dz_t into dWh (the h sequence is never in device memory
//      for a matmul outside to read);
//   3. the (dh, dc) carry goes on into the next older segment.
//
// What bounds it on this card. Per (row, step) the forward recompute, the
// gate recompute and the carry are three H x 4H products, and dWh adds a
// fourth per kept (row, step): at the atari widths about 45 GFLOP of fp32
// work against about 100 MB that the function must move, so the least
// time is set by the fp32 rate.
//
// What the design does about it. A row-tile layout: a block owns
// kRows batch rows for the whole walk, so the recompute, like the walk,
// needs no synchronisation across blocks. The segment's recomputed h and c
// cannot sit in shared memory for every S (at H=2048 and S=85 it would be
// 5.6 MB per block), so they go to a global scratch the wrapper allocates,
// (S+1, B, H) twice; each block reads and writes only its own rows. Shared
// memory stays lstm_seq_bwd_fused.cu's 7*kRows*H floats (229,376 bytes at
// H=2048, under the 232,448 a block may have): the recompute double-buffers
// h in the tiles the walk later uses for h and dz. dWh is added into a
// per-block partial and the partials are summed by the block that finishes
// last, as in lstm_seq_bwd_fused.cu: one launch, the same bits every run.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;       // batch rows per block
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[r][g] = sum_k h[r, k] * wh[k, g*H+j]: the four gate columns of unit j
// for every row of the tile, summed over k in order
__device__ __forceinline__ void gate_products(const float* __restrict__ wh,
                                              const float* h, int j, int H,
                                              float (&acc)[kRows][4]) {
  const int H4 = 4 * H;
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
      const float hk = h[r * H + k];
      acc[r][0] = fmaf(hk, w0, acc[r][0]);
      acc[r][1] = fmaf(hk, w1, acc[r][1]);
      acc[r][2] = fmaf(hk, w2, acc[r][2]);
      acc[r][3] = fmaf(hk, w3, acc[r][3]);
    }
  }
}

// dWh[k, g*H+j] += sum_r h[r, k] * d[r][g] for every k, into this block's
// partial, kK rows of loads in flight (see lstm_seq_bwd_fused.cu)
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
lstm_seq_bwd_ckpt_kernel(const float* __restrict__ dout,    // (T, B, H)
                         const float* __restrict__ proj,    // (T, B, 4H)
                         const float* __restrict__ h_ckpt,  // (N, B, H)
                         const float* __restrict__ c_ckpt,  // (N, B, H)
                         const float* __restrict__ wh,      // (H, 4H)
                         const float* __restrict__ whT,     // (4H, H)
                         const float* __restrict__ dcT,     // (B, H)
                         const int* __restrict__ burn,      // (B,)
                         float* __restrict__ dz,            // (T, B, 4H)
                         float* __restrict__ dwh,           // (H, 4H)
                         float* part,   // (blocks, H, 4H) workspace
                         int* ticket,   // 1 int, zero at launch
                         float* seg_h,  // (S+1, B, H) scratch
                         float* seg_c,  // (S+1, B, H) scratch
                         int T, int B, int H, int S) {
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

  for (int seg = T / S - 1; seg >= 0; --seg) {
    const int base = seg * S;
    // 1. forward recompute from the segment's checkpoint. h is
    // double-buffered in h_s and the dz_s tile, which the previous
    // segment's carry product may still be reading.
    __syncthreads();
    float* h_cur = h_s;
    float* h_nxt = dz_s;
    for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
      const int r = idx / H, j = idx - r * H, row = row0 + r;
      const bool ok = row < B;
      const size_t o = ((size_t)seg * B + row) * H + j;
      h_cur[idx] = ok ? h_ckpt[o] : 0.0f;
      h_nxt[idx] = 0.0f;  // padding rows stay 0 in both buffers
      if (ok) {
        seg_h[(size_t)row * H + j] = h_ckpt[o];
        seg_c[(size_t)row * H + j] = c_ckpt[o];
      }
    }
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      const int t = base + s;
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        float acc[kRows][4];
        gate_products(wh, h_cur, j, H, acc);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = row0 + r;
          if (row >= B) continue;
          const float* p = proj + ((size_t)t * B + row) * H4 + j;
          const float ig = sigmoid_f32(p[0] + acc[r][0]);
          const float fg = sigmoid_f32(p[H] + acc[r][1]);
          const float gg = tanhf(p[2 * H] + acc[r][2]);
          const float og = sigmoid_f32(p[3 * H] + acc[r][3]);
          // c_{t-1} of unit j was written by this thread (or before the
          // barrier above)
          const float c = fg * seg_c[((size_t)s * B + row) * H + j] + ig * gg;
          const float h = og * tanhf(c);
          h_nxt[r * H + j] = h;
          const size_t o = ((size_t)(s + 1) * B + row) * H + j;
          seg_h[o] = h;
          seg_c[o] = c;
        }
      }
      __syncthreads();  // h_t complete before anyone reads it as h_{t-1}
      float* tmp = h_cur;
      h_cur = h_nxt;
      h_nxt = tmp;
    }

    // 2. reverse walk over the segment, the seam on the real step
    for (int s = S - 1; s >= 0; --s) {
      const int t = base + s;
      for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
        const int r = idx / H, j = idx - r * H, row = row0 + r;
        h_s[idx] = (row < B) ? seg_h[((size_t)s * B + row) * H + j] : 0.0f;
      }
      // also orders the previous step's carry reads of dz_s before the
      // writes below
      __syncthreads();

      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        float acc[kRows][4];
        gate_products(wh, h_s, j, H, acc);
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
          const size_t c_lo = ((size_t)s * B + row) * H + j;  // c_{t-1}
          const size_t c_hi = c_lo + (size_t)B * H;           // c_t
          const float* p = proj + o4;
          const float ig = sigmoid_f32(p[0] + acc[r][0]);
          const float fg = sigmoid_f32(p[H] + acc[r][1]);
          const float gg = tanhf(p[2 * H] + acc[r][2]);
          const float og = sigmoid_f32(p[3 * H] + acc[r][3]);
          const float tc = tanhf(seg_c[c_hi]);
          const float dh = (t >= seam[r] ? dout[o1] : 0.0f) + dh_s[r * H + j];
          const float d_o = dh * tc;
          const float dc = dh * og * (1.0f - tc * tc) + dc_s[r * H + j];
          const float di = dc * gg;
          const float df = dc * seg_c[c_lo];
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

extern "C" int lstm_seq_bwd_ckpt_launch(const float* dout, const float* proj,
                                        const float* h_ckpt, const float* c_ckpt,
                                        const float* wh, const float* whT,
                                        const float* dcT, const int* burn, float* dz,
                                        float* dwh, float* part, int* ticket,
                                        float* seg_h, float* seg_c, int T, int B,
                                        int H, int S, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  int threads = ((H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (7 * (size_t)kRows * H + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lstm_seq_bwd_ckpt_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_seq_bwd_ckpt_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      dout, proj, h_ckpt, c_ckpt, wh, whT, dcT, burn, dz, dwh, part, ticket, seg_h,
      seg_c, T, B, H, S);
  return (int)cudaGetLastError();
}

extern "C" const char* lstm_seq_bwd_ckpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
