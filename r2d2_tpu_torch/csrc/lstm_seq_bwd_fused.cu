// Reverse-time LSTM backward with the per-row burn-in seam and the
// recurrent-weight gradient formed in the kernel, for Hopper (sm_90a), in
// float32 and in bf16.
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
// The bf16 form (lstm_seq_bwd_fused_bf16_launch) takes proj, hprev and wh
// in bf16 (dout, cprev, cs and dcT stay f32) and writes dz in bf16, as the
// Pallas kernel does: the gates are recomputed from the bf16 hprev, and
// the carry product is bf16(dz) @ wh^T summed in f32. The Pallas kernel
// sums dWh from the unrounded f32 dz. This form runs every product on the
// tensor cores (column_split.cuh, mma.sync m16n8k16, bf16 operands summed
// in f32): the walk's gate recompute and carry as lstm_seq_bwd.cu's bf16
// form does, and the dWh pass as K5's bf16 form does (Walk::add_dwh_tc),
// from the f32 dz split into two bf16 planes: hi = bf16(dz), the dz it
// writes, and lo = bf16(dz - hi), which the walk writes into a window of
// W steps (dz_lo, (W, B, 4H) bf16; a (T, B, 4H) f32 copy would be the very
// buffer whose size makes the backward-arm choice pick this arm), and
// dWh += h^T hi + h^T lo, so dz enters dWh with about 16 bits of mantissa
// (|dz - hi - lo| <= 2^-17 |dz|).
//
// What bounds it on this card. The walk's two H x 4H products per (row,
// step) plus dWh, another 2*H*4H per kept (row, step) (two in bf16: the
// planes): at the atari widths about 34 GFLOP of fp32 work against about
// 150 MB that the function must move (about 90 MB in bf16), so the least
// time is set by the fp32 rate of the FMA units in float32 and by the
// bytes in bf16; the sequential floor is T steps of one exchange of dz_t
// and one grid barrier.
//
// What the design does about it: one cooperative launch with the column
// split (column_split.cuh, Walk).
//   1. lstm_seq_bwd.cu's loop: the same steps in the same geometry, so dz
//      is lstm_seq_bwd.cu's dz bit for bit (in bf16: its f32 dz rounded,
//      since bf16(dz_t) is what both exchange, and lstm_kernel gives the
//      two bf16 forms one split). In bf16 the dz output is also the
//      exchange: each step has its own slot, so no ring.
//   2. Each block owns dWh[:, its 4Hb gate columns] (H x 4Hb) outright and
//      adds hprev^T @ dz[:, :, its columns] into dwh (Walk::add_dwh; bf16:
//      add_dwh_tc) in one order: no per-block partials, no atomics, no
//      ticket, the same bits every launch. The pass reads only the block's
//      own dz columns, which its own threads wrote, and hprev, an input: a
//      block barrier orders it after their writes, and no grid barrier is
//      needed. In float32 one pass after the walk reads the dz output,
//      over (t, b). In bf16 the walk also writes the block's low-plane
//      columns into slot t % W of the window; after each step t that is a
//      multiple of W (the newest window ragged where W does not divide T)
//      the block adds the window's steps t .. t+W-1 (hi: dz's rows t ..,
//      lo: the window from slot 0, contiguous since t is a multiple of W),
//      then goes on to the grid barrier. The pass stages its tiles in the
//      walk's staging tiles where wh is pinned (the pinned slices, the dh
//      carry after the tiles and the dc registers stay), and in all its
//      tile buffers where wh is streamed (restaged every step anyway); it
//      ends in a block barrier, so the next steps' writes into the window,
//      and the carry product's use of the tiles, come after its reads. A
//      batch walked in row chunks changes none of this: every chunk's dz
//      columns of the block are its own threads'.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

template <class E, bool kChunked>
__global__ void __launch_bounds__(kTensorCoreFormThreads<E>)
lstm_seq_bwd_fused_kernel(const float* __restrict__ dout,   // (T, B, H)
                          const E* __restrict__ proj,       // (T, B, 4H)
                          const E* __restrict__ hprev,      // (T, B, H)
                          const float* __restrict__ cprev,  // (T, B, H)
                          const float* __restrict__ cs,     // (T, B, H)
                          const E* __restrict__ wh,         // (H, 4H)
                          const float* __restrict__ dcT,    // (B, H)
                          const int* __restrict__ burn,     // (B,)
                          E* dz,         // (T, B, 4H); read back by other blocks: not restrict
                          float* dwh,    // (H, 4H)
                          E* dz_lo,      // bf16: (W, B, 4H) low plane of dz; float: unused
                          float* carry,  // more than one chunk: (2, grid, chunks*Bc, Hb)
                          int* bar,      // (2,) grid barrier, zeroed
                          int T, int B, int H, int W, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  // bf16: every product on the tensor cores
  constexpr bool kTC = !kF32<E>;
  Walk<E, kChunked> w(smem, wh, dcT, burn, B, H, Hb, kt, pinned, Bc, carry);
  const size_t BH = (size_t)B * H;
  // 1. the seam walk, lstm_seq_bwd.cu's loop
  for (int t = T - 1; t >= 0; --t) {
    E* dz_t = dz + t * 4 * BH;
    E* lo_t = nullptr;  // bf16: the low plane of the dz that dWh sums
    if constexpr (kTC) lo_t = dz_lo + (t % W) * 4 * BH;
    for (int c = 0; c < w.n_chunks(); ++c)
      w.template dz_step<true>(t, c, dout + t * BH, proj + t * 4 * BH, hprev + t * BH,
                               cprev + t * BH, cs + t * BH, dz_t, lo_t);
    if constexpr (kTC) {
      if (t % W == 0) {  // 2. the window's steps t .. t+W-1 into the block's dWh columns
        __syncthreads();  // the block's dz columns and low plane of the window are written
        w.add_dwh_tc(dwh, [&](int s) { return hprev + (t + s) * BH; }, dz_t, dz_lo,
                     imin(W, T - t), t + W < T);
      }
    }
    if (t == 0) break;  // the carry out of step 0 is not wanted
    grid_barrier(bar);  // dz[t] complete before anyone reads it
    for (int c = 0; c < w.n_chunks(); ++c) {
      float a[4][4];
      w.carry_product(a, dz_t, c);
      w.template store_carry<true>(a, t, c);
    }
  }
  if constexpr (!kTC) {
    // 2. the block's dWh columns over all T steps
    __syncthreads();  // the block's dz columns of every step are written
    w.add_dwh(dwh, [&](int s) { return hprev + s * BH; }, dz, T, false);
  }
}

template <class E>
int launch(const float* dout, const E* proj, const E* hprev, const float* cprev, const float* cs,
           const E* wh, const float* dcT, const int* burn, E* dz, float* dwh, E* dz_lo,
           float* carry, int* bar, int T, int B, int H, int W, int Hb, int grid, int threads,
           int kt, int pinned, int smem, int Bc, void* stream) {
  if (!kF32<E> && (W <= 0 || !dz_lo)) return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(
      B > Bc ? lstm_seq_bwd_fused_kernel<E, true> : lstm_seq_bwd_fused_kernel<E, false>, grid,
      threads, smem, stream, dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, dwh, dz_lo, carry,
      bar, T, B, H, W, Hb, kt, pinned, Bc);
}

}  // namespace

extern "C" int lstm_seq_bwd_fused_launch(const float* dout, const float* proj,
                                         const float* hprev, const float* cprev,
                                         const float* cs, const float* wh, const float* dcT,
                                         const int* burn, float* dz, float* dwh, float* dz_lo,
                                         float* carry, int* bar, int T, int B, int H, int W,
                                         int Hb, int grid, int threads, int kt, int pinned,
                                         int smem, int Bc, void* stream) {
  return launch(dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, dwh, dz_lo, carry, bar, T, B, H,
                W, Hb, grid, threads, kt, pinned, smem, Bc, stream);
}

extern "C" int lstm_seq_bwd_fused_bf16_launch(const float* dout, const bf16* proj,
                                              const bf16* hprev, const float* cprev,
                                              const float* cs, const bf16* wh, const float* dcT,
                                              const int* burn, bf16* dz, float* dwh, bf16* dz_lo,
                                              float* carry, int* bar, int T, int B, int H, int W,
                                              int Hb, int grid, int threads, int kt, int pinned,
                                              int smem, int Bc, void* stream) {
  return launch(dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, dwh, dz_lo, carry, bar, T, B, H,
                W, Hb, grid, threads, kt, pinned, smem, Bc, stream);
}

extern "C" const char* lstm_seq_bwd_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
