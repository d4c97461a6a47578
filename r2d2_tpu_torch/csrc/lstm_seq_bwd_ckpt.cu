// Gradient-checkpointed LSTM backward with the per-row burn-in seam and the
// recurrent-weight gradient formed in the kernel, for Hopper (sm_90a),
// float32.
//
// Replaces the TPU kernel `_seq_bwd_ckpt_kernel` / `_lstm_seq_bwd_ckpt_call`
// of r2d2_tpu/ops/pallas_lstm.py (the ckpt backward arm). The forward saved
// only the (h, c) carries entering each S-step segment, h_ckpt / c_ckpt
// (N = T/S, B, H). Per segment, newest first (base = seg*S):
//   1. the segment's forward is recomputed from its checkpoint with the
//      forward kernel's step (lstm_fwd.cu);
//   2. the segment is walked in reverse with lstm_seq_bwd.cu's step, the
//      masks keep = t >= burn[b] and carry_keep = t > burn[b] on the real
//      step t = base + s, writing dz[t];
//   3. h_{t-1}^T @ dz_t over the segment's steps is added into dWh;
//   4. the (dh, dc) carry goes on into the next older segment.
//
// What bounds it on this card. Per (row, step) the forward recompute, the
// gate recompute and the carry are three H x 4H products, and dWh adds a
// fourth: at the atari widths about 45 GFLOP of fp32 work against about
// 100 MB that the function must move, so the least time is set by the fp32
// rate. The sequential floor is about 2T grid barriers, one per step of
// the recompute and one per step of the walk.
//
// What the design does about it: one cooperative launch with the column
// split of the forward and seam backward (column_split.cuh). Block x owns
// Hb hidden units, their gate columns and rows of wh (pinned in shared
// memory at H=512, streamed at H=2048) and all B rows.
//   1. The recompute writes h for its units into seg_h (S+1, B, H), the
//      exchange buffer every block reads whole after each grid barrier, as
//      the forward does with outs; step 0 reads h_ckpt[seg] itself. c goes
//      to seg_c for the block's own units only, read back by the same
//      threads: no exchange. seg_h[0] and seg_c[0] are not used.
//   2. The walk is Walk's step; dz[t] is the output and the exchange
//      buffer, and the block's (dh, dc) carry stays on the SM across
//      segment boundaries.
//   3. The block owns dWh[:, its 4Hb gate columns] (H x 4Hb) outright and
//      adds seg_h[0..S-1]^T @ dz[base..base+S-1][:, :, its columns] into
//      dwh (Walk::add_dwh): no per-block partials, no atomics, one order
//      (segments newest first, then (s, b)), the same bits every launch.
//   4. A grid barrier before the next segment's recompute writes seg_h,
//      which other blocks may still be reading in their dWh pass.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

__global__ void __launch_bounds__(kMaxThreads)
lstm_seq_bwd_ckpt_kernel(const float* __restrict__ dout,    // (T, B, H)
                         const float* __restrict__ proj,    // (T, B, 4H)
                         const float* __restrict__ h_ckpt,  // (N, B, H)
                         const float* __restrict__ c_ckpt,  // (N, B, H)
                         const float* __restrict__ wh,      // (H, 4H)
                         const float* __restrict__ dcT,     // (B, H)
                         const int* __restrict__ burn,      // (B,)
                         float* dz,      // (T, B, 4H); read back by other blocks
                         float* dwh,     // (H, 4H)
                         float* seg_h,   // (S+1, B, H) scratch, read back by other blocks
                         float* seg_c,   // (S+1, B, H) scratch
                         int* bar,       // (2,) grid barrier, zeroed
                         int T, int B, int H, int S, int Hb, int kt, int pinned) {
  extern __shared__ float smem[];
  Walk w(smem, wh, dcT, burn, B, H, Hb, kt, pinned);
  const size_t BH = (size_t)B * H;
  const int N = T / S;
  for (int seg = N - 1; seg >= 0; --seg) {
    const int base = seg * S;
    const float* h_seg = h_ckpt + seg * BH;
    const float* c_seg = c_ckpt + seg * BH;
    auto hrows = [&](int s) -> const float* { return s == 0 ? h_seg : seg_h + s * BH; };

    // 1. the forward recompute, the forward kernel's step
    float c[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] = __ldg(c_seg + (size_t)w.row[r] * H + w.j);
    for (int s = 0; s < S; ++s) {
      const int t = base + s;
      float z[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* p = proj + ((size_t)t * B + w.row[r]) * 4 * H + w.j;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[r][g] = w.it.owner() ? __ldg(p + g * H) : 0.0f;
      }
      float acc[4][4];
      gate_product(acc, hrows(s), wh, w.wc, w.st, w.red, w.it, B, w.Bp, H, Hb, w.j0, w.n_units,
                   kt, pinned);
      if (w.it.owner() && w.unit_ok) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ig = sigmoid_f32(z[r][0] + acc[r][0]);
          const float fg = sigmoid_f32(z[r][1] + acc[r][1]);
          const float gg = tanhf(z[r][2] + acc[r][2]);
          const float og = sigmoid_f32(z[r][3] + acc[r][3]);
          c[r] = fg * c[r] + ig * gg;
          if (w.it.rg + r * w.nrg >= B) continue;
          const size_t o = (s + 1) * BH + (size_t)w.row[r] * H + w.j;
          seg_c[o] = c[r];
          if (s + 1 < S) seg_h[o] = og * tanhf(c[r]);  // the last h is not needed
        }
      }
      if (s + 1 < S) grid_barrier(bar);  // h_t complete before anyone reads it
    }

    // 2. the reverse walk, the seam on the real step
    for (int s = S - 1; s >= 0; --s) {
      const int t = base + s;
      float* dz_t = dz + t * 4 * BH;
      w.dz_step<true>(t, dout + t * BH, proj + t * 4 * BH, hrows(s),
                      s == 0 ? c_seg : seg_c + s * BH, seg_c + (s + 1) * BH, dz_t);
      if (t == 0) break;  // the carry out of step 0 is not wanted
      grid_barrier(bar);  // dz[t] complete before anyone reads it
      float a[4][4];
      w.carry_product(a, dz_t);
      w.store_carry<true>(a, t);
    }

    // 3. this segment's part of the block's dWh columns
    __syncthreads();  // the block's dz columns of step base are written
    w.add_dwh(dwh, hrows, dz + base * 4 * BH, S, seg < N - 1);

    // 4. everyone is done reading seg_h before it is written again
    if (seg > 0) grid_barrier(bar);
  }
}

}  // namespace

extern "C" int lstm_seq_bwd_ckpt_launch(const float* dout, const float* proj,
                                        const float* h_ckpt, const float* c_ckpt,
                                        const float* wh, const float* dcT, const int* burn,
                                        float* dz, float* dwh, float* seg_h, float* seg_c,
                                        int* bar, int T, int B, int H, int S, int Hb, int grid,
                                        int threads, int kt, int pinned, int smem,
                                        void* stream) {
  if (S <= 0 || T % S) return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(lstm_seq_bwd_ckpt_kernel, grid, threads, smem, stream, dout,
                                 proj, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh, seg_h, seg_c, bar,
                                 T, B, H, S, Hb, kt, pinned);
}

extern "C" const char* lstm_seq_bwd_ckpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
