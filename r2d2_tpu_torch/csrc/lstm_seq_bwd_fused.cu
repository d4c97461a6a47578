// Reverse-time LSTM backward with the per-row burn-in seam and the
// recurrent-weight gradient formed in the kernel, for Hopper (sm_90a),
// float32.
//
// Replaces the TPU kernel `_seq_bwd_fused_kernel` /
// `_lstm_seq_bwd_fused_call` of r2d2_tpu/ops/pallas_lstm.py (the fused_dwh
// backward arm). The reverse walk is the seam walk of lstm_seq_bwd.cu:
// keep = t >= burn[b] masks the step's output cotangent, carry_keep =
// t > burn[b] cuts the (dh, dc) carry into t-1, dz[t] is written out and
// is exactly 0 below each row's seam. On top of it, dWh = sum_t
// h_{t-1}^T @ dz_t (H, 4H) is formed in the same launch, so no matmul over
// (T*B) is left outside the kernel.
//
// What bounds it on this card. The walk's two H x 4H products per (row,
// step) plus dWh, another 2*H*4H per kept (row, step): at the atari widths
// about 34 GFLOP of fp32 work against about 150 MB that the function must
// move, so the least time is set by the fp32 rate; the sequential floor is
// T steps of one exchange of dz_t and one grid barrier.
//
// What the design does about it: one cooperative launch with the column
// split (column_split.cuh, Walk), in two parts.
//   1. lstm_seq_bwd.cu's loop, unchanged: the same steps in the same
//      geometry, so dz is lstm_seq_bwd.cu's dz bit for bit.
//   2. Each block owns dWh[:, its 4Hb gate columns] (H x 4Hb) outright and
//      adds hprev^T @ dz[:, :, its columns] over all T steps into dwh
//      (Walk::add_dwh), in one order ((t, b)): no per-block partials, no
//      atomics, no ticket, the same bits every launch. The pass reads only
//      the block's own dz columns, which its own threads wrote, and hprev,
//      an input: a block barrier orders it after the walk, and no grid
//      barrier is needed. A batch walked in row chunks changes none of
//      this: every chunk's dz columns of the block are its own threads'.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

template <bool kChunked>
__global__ void __launch_bounds__(kMaxThreads)
lstm_seq_bwd_fused_kernel(const float* __restrict__ dout,   // (T, B, H)
                          const float* __restrict__ proj,   // (T, B, 4H)
                          const float* __restrict__ hprev,  // (T, B, H)
                          const float* __restrict__ cprev,  // (T, B, H)
                          const float* __restrict__ cs,     // (T, B, H)
                          const float* __restrict__ wh,     // (H, 4H)
                          const float* __restrict__ dcT,    // (B, H)
                          const int* __restrict__ burn,     // (B,)
                          float* dz,     // (T, B, 4H); read back by other blocks: not restrict
                          float* dwh,    // (H, 4H)
                          float* carry,  // more than one chunk: (2, grid, chunks*Bc, Hb)
                          int* bar,      // (2,) grid barrier, zeroed
                          int T, int B, int H, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  Walk<float, kChunked> w(smem, wh, dcT, burn, B, H, Hb, kt, pinned, Bc, carry);
  const size_t BH = (size_t)B * H;
  // 1. the seam walk, lstm_seq_bwd.cu's loop
  for (int t = T - 1; t >= 0; --t) {
    float* dz_t = dz + t * 4 * BH;
    for (int c = 0; c < w.n_chunks(); ++c)
      w.template dz_step<true>(t, c, dout + t * BH, proj + t * 4 * BH, hprev + t * BH, cprev + t * BH,
                      cs + t * BH, dz_t, nullptr);
    if (t == 0) break;  // the carry out of step 0 is not wanted
    grid_barrier(bar);  // dz[t] complete before anyone reads it
    for (int c = 0; c < w.n_chunks(); ++c) {
      float a[4][4];
      w.carry_product(a, dz_t, c);
      w.template store_carry<true>(a, t, c);
    }
  }
  // 2. the block's dWh columns over all T steps
  __syncthreads();  // the block's dz columns of every step are written
  w.add_dwh(dwh, [&](int s) { return hprev + s * BH; }, dz, T, false);
}

}  // namespace

extern "C" int lstm_seq_bwd_fused_launch(const float* dout, const float* proj,
                                         const float* hprev, const float* cprev,
                                         const float* cs, const float* wh, const float* dcT,
                                         const int* burn, float* dz, float* dwh, float* carry,
                                         int* bar, int T, int B, int H, int Hb, int grid,
                                         int threads, int kt, int pinned, int smem, int Bc,
                                         void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(
      B > Bc ? lstm_seq_bwd_fused_kernel<true> : lstm_seq_bwd_fused_kernel<false>, grid, threads,
      smem, stream, dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, dwh, carry, bar, T, B, H, Hb,
      kt, pinned, Bc);
}

extern "C" const char* lstm_seq_bwd_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
