// Reverse-time LSTM backward with no seam, for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `_bwd_kernel` / `_lstm_bwd_call` of
// r2d2_tpu/ops/pallas_lstm.py, the backward of `lstm_unroll` (the unroll
// without the burn-in seam, fused_sequence=False). Walking t from T-1 down
// to 0, the step's gates are recomputed from the saved h_{t-1} (hprev),
// c_{t-1} (cprev) and c_t (cs), the pre-activation gradient dz[t] (4H wide,
// i,f,g,o order) is written out, and the carry moves on as dh = dz @ wh^T,
// dc = dc * f, through every step: after t=0 the carry is the cotangent of
// the initial state, written to dh0 / dc0. dWh = hprev^T @ dz is one large
// matmul outside the kernel, as the JAX package leaves it to XLA.
//
// What bounds it on this card. Each (row, step) does two H x 4H products,
// the gate recompute and the carry: at the atari widths (T=85, B=64,
// H=512) 22.8 GFLOP against about 140 MB of device-memory traffic, so the
// least time is set by the fp32 rate. The sequential floor is T steps of
// one exchange of dz_t and one grid barrier.
//
// What the design does about it: lstm_seq_bwd.cu's column-split walk
// (column_split.cuh, Walk) with both seam masks gone. Block x of a
// persistent cooperative grid owns Hb hidden units, their gate columns and
// rows of wh (pinned in shared memory at H=512, streamed at H=2048) and all
// B rows; per step it recomputes its gates, writes its columns of dz[t]
// (the output and the exchange buffer), meets the grid at one barrier,
// and forms dh for its units from the whole dz[t] against wh's rows (no
// wh^T copy). The carry also runs after step 0, so T barriers: each block
// then writes dh0 for its units from that product and dc0 from its dc
// registers. A batch wider than one chunk of rows is walked in chunks
// inside each step, the carry then kept in the block's slabs of `carry`.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

template <bool kChunked>
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_kernel(const float* __restrict__ dout,   // (T, B, H)
                const float* __restrict__ proj,   // (T, B, 4H)
                const float* __restrict__ hprev,  // (T, B, H)
                const float* __restrict__ cprev,  // (T, B, H)
                const float* __restrict__ cs,     // (T, B, H)
                const float* __restrict__ wh,     // (H, 4H)
                const float* __restrict__ dcT,    // (B, H)
                float* dz,                        // (T, B, 4H); read back by other blocks
                float* __restrict__ dh0,          // (B, H)
                float* __restrict__ dc0,          // (B, H)
                float* carry,  // more than one chunk: (2, grid, chunks*Bc, Hb)
                int* bar,      // (2,) grid barrier, zeroed
                int T, int B, int H, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  Walk<float, kChunked> w(smem, wh, dcT, nullptr, B, H, Hb, kt, pinned, Bc, carry);
  const size_t BH = (size_t)B * H;
  for (int t = T - 1; t >= 0; --t) {
    float* dz_t = dz + t * 4 * BH;
    for (int c = 0; c < w.n_chunks(); ++c)
      w.template dz_step<false>(t, c, dout + t * BH, proj + t * 4 * BH, hprev + t * BH, cprev + t * BH,
                       cs + t * BH, dz_t, nullptr);
    grid_barrier(bar);  // dz[t] complete before anyone reads it
    for (int c = 0; c < w.n_chunks(); ++c) {
      float a[4][4];
      w.carry_product(a, dz_t, c);
      if (t > 0)
        w.template store_carry<false>(a, t, c);
      else
        w.store_dh(a, dh0, c);  // the carry out of step 0: d h0
    }
  }
  w.store_dc(dc0);
}

}  // namespace

extern "C" int lstm_bwd_launch(const float* dout, const float* proj, const float* hprev,
                               const float* cprev, const float* cs, const float* wh,
                               const float* dcT, float* dz, float* dh0, float* dc0, float* carry,
                               int* bar, int T, int B, int H, int Hb, int grid, int threads,
                               int kt, int pinned, int smem, int Bc, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(B > Bc ? lstm_bwd_kernel<true> : lstm_bwd_kernel<false>, grid,
                                 threads, smem, stream, dout, proj, hprev, cprev, cs, wh, dcT, dz,
                                 dh0, dc0, carry, bar, T, B, H, Hb, kt, pinned, Bc);
}

extern "C" const char* lstm_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
