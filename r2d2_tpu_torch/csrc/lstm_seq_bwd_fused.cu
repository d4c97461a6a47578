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
// form does, and the dWh pass as a two-plane product (mma_tile_at): the
// f32 dz split into hi = bf16(dz), the dz it writes, and lo = bf16(dz -
// hi), and dWh += h^T hi + h^T lo, so dz enters dWh with about 16 bits of
// mantissa (|dz - hi - lo| <= 2^-17 |dz|).
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
//   1. lstm_seq_bwd.cu's loop on its bulk ring: the same steps in the same
//      geometry (lstm_kernel gives the two bf16 forms one split), dz_t
//      (bf16: rounded) written into the two-step exchange ring xch and
//      taken by the carry product tile by tile with TMA bulk copies into
//      the mbarrier stage ring, in the cp.async walk's tile order; where wh
//      is streamed each block lays out its rows of wh in xch once. So dz
//      is lstm_seq_bwd.cu's dz bit for bit (in bf16: its f32 dz rounded).
//      lstm_seq_bwd_fused_exchange_ring_elems sizes the ring.
//   2. The dWh pass reads a window of W steps (W = DWH_WINDOW, the last
//      ragged where W does not divide T): each step also writes the
//      block's dz columns into its slot t % W of `win` (column_split.cuh
//      DwhWindow: per block, rows of the block's columns laid out as the
//      pass stages them; float dz, bf16 its two planes). After each step t
//      that is a multiple of W, the block adds the window's steps
//      t .. t+W-1 (Walk::add_dwh_window): per stage, each row of h by one
//      TMA bulk copy and the window's rows of each plane by one more, on a
//      stage ring of its own, no 4-byte copy. Each block owns dWh[:, its
//      4Hb gate columns] (H x 4Hb) outright: no per-block partials, no
//      atomics, one order (windows newest first; in a window m = s*B + b in
//      order per output, bf16 the hi product before the lo one per m16
//      step), the same bits every launch. The pass reads only the block's
//      own window, which its own threads wrote, and hprev, an input: a
//      block barrier orders it after their writes, and no grid barrier is
//      needed; it runs before the step's grid barrier (run between the
//      block's arrival there and its wait, it was no faster on an H100 at
//      the atari, wide or xl widths).
//   3. The pass stages in the walk's staging tiles where wh is pinned (the
//      pinned slices, the dh carry after the tiles and the dc registers
//      stay), and in all its tile buffers where wh is streamed (restaged
//      every step anyway; the walk's ring barriers there are set up again
//      after it). A batch walked in row chunks changes none of this: every
//      chunk's dz columns of the block are its own threads'.
//   lstm_seq_bwd_fused_dwh_launch runs the passes alone, for timing.

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
                          E* dz,         // (T, B, 4H)
                          float* dwh,    // (H, 4H)
                          E* win,        // the dWh pass's window (DwhWindow)
                          E* xch,        // the exchange ring (ExchangeRing)
                          float* carry,  // more than one chunk: (2, grid, chunks*Bc, Hb)
                          int* bar,      // (2,) grid barrier, zeroed
                          int T, int B, int H, int W, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  // bf16: every product on the tensor cores (Walk::kTC)
  Walk<E, kChunked, true> w(smem, wh, dcT, burn, B, H, Hb, kt, pinned, Bc, carry);
  w.tile_wh(xch);  // where wh is streamed
  const DwhWindow<E> window(win, W, B, Hb);
  window.zero();  // bf16: ordered before the first pass by the steps' block barriers
  const size_t BH = (size_t)B * H;
  for (int t = T - 1; t >= 0; --t) {
    // what the blocks exchange: dz_t (bf16: rounded), in the two-step ring
    E* x_t = w.exchange_at(xch, t);
    for (int c = 0; c < w.n_chunks(); ++c)
      w.template dz_step<true>(t, c, dout + t * BH, proj + t * 4 * BH, hprev + t * BH,
                               cprev + t * BH, cs + t * BH, dz + t * 4 * BH, (E*)nullptr, x_t,
                               window.slot(t % W, B), window.plane);
    if (t % W == 0) {  // the window's steps t .. t+W-1 into the block's dWh columns
      __syncthreads();  // the block's window rows are written
      w.add_dwh_window(dwh, [&](int s) { return hprev + (t + s) * BH; }, window, imin(W, T - t),
                       t + W < T);
    }
    if (t == 0) break;  // the carry out of step 0 is not wanted
    grid_barrier(bar);  // x_t complete before anyone reads it
    for (int c = 0; c < w.n_chunks(); ++c) {
      float a[4][4];
      w.carry_product(a, x_t, c);
      w.template store_carry<true>(a, t, c);
    }
  }
}

// The dWh passes alone, for timing: the walk's T / W windows (newest
// first) of add_dwh_window over hprev and the window as it stands, with
// no walk and no grid barrier, in K4's geometry with the batch in one
// chunk.
template <class E>
__global__ void __launch_bounds__(kTensorCoreFormThreads<E>)
dwh_pass_kernel(const E* __restrict__ hprev, const E* __restrict__ wh,
                const float* __restrict__ dcT, float* dwh, E* win, int T, int B, int H, int W,
                int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  Walk<E, false, true> w(smem, wh, dcT, nullptr, B, H, Hb, kt, pinned, Bc, nullptr);
  copies_commit();  // the pinned slices of wh, which no product waits for here
  copies_wait<0>();
  const DwhWindow<E> window(win, W, B, Hb);
  const size_t BH = (size_t)B * H;
  for (int t = (T - 1) / W * W; t >= 0; t -= W) {
    __syncthreads();
    w.add_dwh_window(dwh, [&](int s) { return hprev + (t + s) * BH; }, window, imin(W, T - t),
                     t + W < T);
  }
}

template <class E>
int launch(const float* dout, const E* proj, const E* hprev, const float* cprev, const float* cs,
           const E* wh, const float* dcT, const int* burn, E* dz, float* dwh, E* win, E* xch,
           float* carry, int* bar, int T, int B, int H, int W, int Hb, int grid, int threads,
           int kt, int pinned, int smem, int Bc, void* stream) {
  if (W <= 0 || !win) return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(
      B > Bc ? lstm_seq_bwd_fused_kernel<E, true> : lstm_seq_bwd_fused_kernel<E, false>, grid,
      threads, smem, stream, dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, dwh, win, xch,
      carry, bar, T, B, H, W, Hb, kt, pinned, Bc);
}

template <class E>
int launch_dwh(const E* hprev, const E* wh, const float* dcT, float* dwh, E* win, int T, int B,
               int H, int W, int Hb, int grid, int threads, int kt, int pinned, int smem, int Bc,
               void* stream) {
  if (W <= 0 || !win) return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (B > Bc) return (int)cudaErrorInvalidValue;  // one chunk
  return (int)launch_cooperative(dwh_pass_kernel<E>, grid, threads, smem, stream, hprev, wh, dcT,
                                 dwh, win, T, B, H, W, Hb, kt, pinned, Bc);
}

}  // namespace

extern "C" int lstm_seq_bwd_fused_launch(const float* dout, const float* proj,
                                         const float* hprev, const float* cprev,
                                         const float* cs, const float* wh, const float* dcT,
                                         const int* burn, float* dz, float* dwh, float* win,
                                         float* xch, float* carry, int* bar, int T, int B, int H,
                                         int W, int Hb, int grid, int threads, int kt, int pinned,
                                         int smem, int Bc, void* stream) {
  return launch(dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, dwh, win, xch, carry, bar, T, B,
                H, W, Hb, grid, threads, kt, pinned, smem, Bc, stream);
}

extern "C" int lstm_seq_bwd_fused_bf16_launch(const float* dout, const bf16* proj,
                                              const bf16* hprev, const float* cprev,
                                              const float* cs, const bf16* wh, const float* dcT,
                                              const int* burn, bf16* dz, float* dwh, bf16* win,
                                              bf16* xch, float* carry, int* bar, int T, int B,
                                              int H, int W, int Hb, int grid, int threads, int kt,
                                              int pinned, int smem, int Bc, void* stream) {
  return launch(dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, dwh, win, xch, carry, bar, T, B,
                H, W, Hb, grid, threads, kt, pinned, smem, Bc, stream);
}

// The dWh passes alone (dwh_pass_kernel): hprev (T, B, H), wh (H, 4H),
// dcT (B, H), dwh (H, 4H) and a window of W steps, with K4's geometry and
// the batch in one chunk (else cudaErrorInvalidValue)
extern "C" int lstm_seq_bwd_fused_dwh_launch(const float* hprev, const float* wh,
                                             const float* dcT, float* dwh, float* win, int T,
                                             int B, int H, int W, int Hb, int grid, int threads,
                                             int kt, int pinned, int smem, int Bc, void* stream) {
  return launch_dwh(hprev, wh, dcT, dwh, win, T, B, H, W, Hb, grid, threads, kt, pinned, smem, Bc,
                    stream);
}

extern "C" int lstm_seq_bwd_fused_dwh_bf16_launch(const bf16* hprev, const bf16* wh,
                                                  const float* dcT, float* dwh, bf16* win, int T,
                                                  int B, int H, int W, int Hb, int grid,
                                                  int threads, int kt, int pinned, int smem,
                                                  int Bc, void* stream) {
  return launch_dwh(hprev, wh, dcT, dwh, win, T, B, H, W, Hb, grid, threads, kt, pinned, smem, Bc,
                    stream);
}

// The exchange ring's elements (xch, of `itemsize`-byte values) at the
// fused backward's geometry (column_split.cuh ExchangeRing: the carry
// product's exchange, as lstm_seq_bwd.cu's)
extern "C" long long lstm_seq_bwd_fused_exchange_ring_elems(int itemsize, int B, int H, int Hb,
                                                            int grid, int kt, int pinned,
                                                            int Bc) {
  return exchange_ring_elems(itemsize, B, H, Hb, grid, kt, pinned, Bc, true, false);
}

extern "C" const char* lstm_seq_bwd_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
