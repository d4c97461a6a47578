// Gradient-checkpointed LSTM backward with the per-row burn-in seam and the
// recurrent-weight gradient formed in the kernel, for Hopper (sm_90a), in
// float32 and in bf16.
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
// The bf16 form (lstm_seq_bwd_ckpt_bf16_launch) takes proj, h_ckpt and wh
// in bf16 (c_ckpt, dout and dcT stay f32) and writes dz in bf16, as the
// Pallas kernel does: the recompute keeps h in f32 but every use of it
// rounds it through bf16 (the gates, the dWh product), so the segment's h
// is kept rounded; dz is summed into dWh in f32, before it is rounded. It
// runs all its products on the tensor cores (column_split.cuh, mma.sync
// m16n8k16, bf16 operands summed in f32): the recompute and the walk's
// gate recompute and carry as K1's and K3's bf16 forms do, and the dWh
// pass as a two-plane product (Walk::add_dwh_tc): the f32 dz is split into
// hi = bf16(dz), the dz it writes, and lo = bf16(dz - hi), which the walk
// writes into dz_lo (S, B, 4H) beside it (a bf16 plane, half the f32 copy
// the FMA form kept), and dWh += h^T hi + h^T lo, so dz enters dWh with
// about 16 bits of mantissa (|dz - hi - lo| <= 2^-17 |dz|).
//
// What bounds it on this card. Per (row, step) the forward recompute, the
// gate recompute and the carry are three H x 4H products, and dWh adds a
// fourth (two in bf16: the planes): at the atari widths about 45 GFLOP
// against about 100 MB that the function must move (65 MB in bf16), so
// the least time is set by the fp32 rate in float32 and, in bf16, by the
// tensor cores' rate (0.03 ms at the atari widths, 0.48 at xl). The
// sequential floor is about 2T grid barriers, one
// per step of the recompute and one per step of the walk, each step a
// block's read of the exchanged rows (h or bf16(dz)) through L2. On an
// H100 the bf16 form runs at about 2% of its bound at xl: its steps are
// bound by those reads, as K3's bf16 form is, and its dWh pass by every
// block reading the segment's whole h (a block owns all k rows of its
// dWh columns), about a quarter of its time.
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
//      dwh (Walk::add_dwh; bf16: add_dwh_tc, in k passes of up to 256 dWh
//      rows a pass at xl where the FMA form took 64, the planes copied in
//      16-byte pieces): no per-block partials, no atomics, one order
//      (segments newest first, then (s, b)), the same bits every launch.
//   4. A grid barrier before the next segment's recompute writes seg_h,
//      which other blocks may still be reading in their dWh pass.
// A batch wider than one chunk of rows is walked in chunks inside each
// step: the recompute's c carry is then read back from seg_c, and the
// walk's carry kept in the block's slabs of `carry`.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

template <class E, bool kChunked>
__global__ void __launch_bounds__(kTensorCoreFormThreads<E>)
lstm_seq_bwd_ckpt_kernel(const float* __restrict__ dout,    // (T, B, H)
                         const E* __restrict__ proj,        // (T, B, 4H)
                         const E* __restrict__ h_ckpt,      // (N, B, H)
                         const float* __restrict__ c_ckpt,  // (N, B, H)
                         const E* __restrict__ wh,          // (H, 4H)
                         const float* __restrict__ dcT,     // (B, H)
                         const int* __restrict__ burn,      // (B,)
                         E* dz,          // (T, B, 4H); read back by other blocks
                         float* dwh,     // (H, 4H)
                         E* seg_h,       // (S+1, B, H) scratch, read back by other blocks
                         float* seg_c,   // (S+1, B, H) scratch
                         E* dz_lo,       // bf16: (S, B, 4H) low plane of dz; float: unused
                         float* carry,   // more than one chunk: (2, grid, chunks*Bc, Hb)
                         int* bar,       // (2,) grid barrier, zeroed
                         int T, int B, int H, int S, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  // bf16: every product on the tensor cores
  constexpr bool kTC = !kF32<E>;
  Walk<E, kChunked> w(smem, wh, dcT, burn, B, H, Hb, kt, pinned, Bc, carry);
  const size_t BH = (size_t)B * H;
  const int N = T / S;
  for (int seg = N - 1; seg >= 0; --seg) {
    const int base = seg * S;
    const E* h_seg = h_ckpt + seg * BH;
    const float* c_seg = c_ckpt + seg * BH;
    auto hrows = [&](int s) -> const E* { return s == 0 ? h_seg : seg_h + s * BH; };

    // 1. the forward recompute, the forward kernel's step
    float c[4];
    for (int s = 0; s < S; ++s) {
      const int t = base + s;
      for (int q = 0; q < w.n_chunks(); ++q) {
        if constexpr (kChunked) w.set_chunk(q);
        if (kChunked || s == 0) {  // the chunk's c carry
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const size_t o = (size_t)w.row[r] * H + w.j;
            c[r] = s == 0 ? __ldg(c_seg + o) : __ldcg(seg_c + s * BH + o);
          }
        }
        float z[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const E* p = proj + ((size_t)t * B + w.row[r]) * 4 * H + w.j;
#pragma unroll
          for (int g = 0; g < 4; ++g) z[r][g] = w.it.owner() ? to_f32(__ldg(p + g * H)) : 0.0f;
        }
        float acc[4][4];
        const E* h = hrows(s) + (size_t)w.first(q) * H;
        const int rows = imin(Bc, B - w.first(q));
        if constexpr (kTC)
          gate_product_tc(acc, h, wh, w.wc, w.st, w.red, w.it, rows, Bc, H, Hb, w.j0, w.n_units,
                          kt, pinned);
        else
          gate_product(acc, h, wh, w.wc, w.st, w.red, w.it, rows, Bc, H, Hb, w.j0, w.n_units, kt,
                       pinned);
        if (w.it.owner() && w.unit_ok) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float ig = sigmoid_f32(z[r][0] + acc[r][0]);
            const float fg = sigmoid_f32(z[r][1] + acc[r][1]);
            const float gg = tanhf(z[r][2] + acc[r][2]);
            const float og = sigmoid_f32(z[r][3] + acc[r][3]);
            c[r] = fg * c[r] + ig * gg;
            if (!w.real(r)) continue;
            const size_t o = (s + 1) * BH + (size_t)w.row[r] * H + w.j;
            seg_c[o] = c[r];
            if (s + 1 < S) seg_h[o] = from_f32<E>(og * tanhf(c[r]));  // the last h is not needed
          }
        }
      }
      if (s + 1 < S) grid_barrier(bar);  // h_t complete before anyone reads it
    }

    // 2. the reverse walk, the seam on the real step
    for (int s = S - 1; s >= 0; --s) {
      const int t = base + s;
      E* dz_t = dz + t * 4 * BH;
      E* lo_t = nullptr;  // bf16: the low plane of the dz that dWh sums
      if constexpr (kTC) lo_t = dz_lo + s * 4 * BH;
      for (int q = 0; q < w.n_chunks(); ++q)
        w.template dz_step<true>(t, q, dout + t * BH, proj + t * 4 * BH, hrows(s),
                                 s == 0 ? c_seg : seg_c + s * BH, seg_c + (s + 1) * BH, dz_t,
                                 lo_t);
      if (t == 0) break;  // the carry out of step 0 is not wanted
      grid_barrier(bar);  // dz[t] complete before anyone reads it
      for (int q = 0; q < w.n_chunks(); ++q) {
        float a[4][4];
        w.carry_product(a, dz_t, q);
        w.template store_carry<true>(a, t, q);
      }
    }

    // 3. this segment's part of the block's dWh columns, from the f32 dz
    // (bf16: its two planes)
    __syncthreads();  // the block's dz columns of step base are written
    if constexpr (kTC)
      w.add_dwh_tc(dwh, hrows, dz + base * 4 * BH, dz_lo, S, seg < N - 1);
    else
      w.add_dwh(dwh, hrows, dz + base * 4 * BH, S, seg < N - 1);

    // 4. everyone is done reading seg_h before it is written again
    if (seg > 0) grid_barrier(bar);
  }
}

template <class E>
int launch(const float* dout, const E* proj, const E* h_ckpt, const float* c_ckpt, const E* wh,
           const float* dcT, const int* burn, E* dz, float* dwh, E* seg_h, float* seg_c,
           E* dz_lo, float* carry, int* bar, int T, int B, int H, int S, int Hb, int grid,
           int threads, int kt, int pinned, int smem, int Bc, void* stream) {
  if (S <= 0 || T % S) return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(
      B > Bc ? lstm_seq_bwd_ckpt_kernel<E, true> : lstm_seq_bwd_ckpt_kernel<E, false>, grid,
      threads, smem, stream, dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh, seg_h, seg_c, dz_lo,
      carry, bar, T, B, H, S, Hb, kt, pinned, Bc);
}

}  // namespace

extern "C" int lstm_seq_bwd_ckpt_launch(const float* dout, const float* proj,
                                        const float* h_ckpt, const float* c_ckpt,
                                        const float* wh, const float* dcT, const int* burn,
                                        float* dz, float* dwh, float* seg_h, float* seg_c,
                                        float* dz_lo, float* carry, int* bar, int T, int B,
                                        int H, int S, int Hb, int grid, int threads, int kt,
                                        int pinned, int smem, int Bc, void* stream) {
  return launch(dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh, seg_h, seg_c, dz_lo, carry,
                bar, T, B, H, S, Hb, grid, threads, kt, pinned, smem, Bc, stream);
}

extern "C" int lstm_seq_bwd_ckpt_bf16_launch(const float* dout, const bf16* proj,
                                             const bf16* h_ckpt, const float* c_ckpt,
                                             const bf16* wh, const float* dcT, const int* burn,
                                             bf16* dz, float* dwh, bf16* seg_h, float* seg_c,
                                             bf16* dz_lo, float* carry, int* bar, int T, int B,
                                             int H, int S, int Hb, int grid, int threads, int kt,
                                             int pinned, int smem, int Bc, void* stream) {
  return launch(dout, proj, h_ckpt, c_ckpt, wh, dcT, burn, dz, dwh, seg_h, seg_c, dz_lo, carry,
                bar, T, B, H, S, Hb, grid, threads, kt, pinned, smem, Bc, stream);
}

extern "C" const char* lstm_seq_bwd_ckpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
