// Reverse-time LSTM backward with the per-row burn-in seam, for Hopper
// (sm_90a), in float32 and in bf16.
//
// Replaces the TPU kernel `_seq_bwd_kernel` / `_lstm_seq_bwd_call` of
// r2d2_tpu/ops/pallas_lstm.py. Walking t from T-1 down to 0, for each row b
// with seam burn[b]:
//     keep       = t >= burn[b]   (else the step's output cotangent is 0)
//     carry_keep = t >  burn[b]   (else the (dh, dc) carry into t-1 is cut)
// the step's gates are recomputed from the saved h_{t-1} (hprev), c_{t-1}
// (cprev) and c_t (cs), the pre-activation gradient dz[t] (4H wide, i,f,g,o
// order) is written out, and the carry moves on as dh = dz @ wh^T,
// dc = dc * f. dz is exactly 0 below each row's seam. dWh = hprev^T @ dz
// is NOT computed here: it is one large matmul outside the kernel, as the
// JAX package leaves it to XLA.
//
// The bf16 form (lstm_seq_bwd_bf16_launch) takes proj, hprev and wh in
// bf16 (cprev, cs, dout and dcT stay f32) and writes dz in f32, as the
// Pallas kernel does: the gates are recomputed from the bf16 hprev, and
// the carry product is bf16(dz) @ wh^T summed in f32. dz_t rounded to
// bf16 is what the blocks exchange (a two-step ring, xch, since a block
// may still read step t's while another writes step t-1's).
//
// What bounds it on this card. Each (row, step) does two H x 4H products:
// the gate recompute and the carry. At the atari widths that is about
// 22.8 GFLOP against about 140 MB of device-memory traffic, so the least
// time is set by the fp32 rate; the sequential floor is T steps of one
// exchange of dz_t and one grid barrier.
//
// What the design does about it: the column split's reverse walk
// (column_split.cuh, Walk), one grid barrier per step. Block x owns Hb
// hidden units, their four gate columns of wh (for the recompute) and their
// Hb rows of wh (for the carry), pinned in shared memory where they fit
// (32 KB each at H=512) or streamed in k-tiles (H=2048), and all B rows;
// dz[t] is both the output and the exchange buffer, read whole by every
// block after the barrier. The (dh, dc) carry of the block's units never
// leaves the SM. No wh^T copy is needed: the carry reads wh's rows. A
// batch wider than one chunk of rows is walked in chunks inside each
// step, the carry then kept in the block's slabs of `carry`.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

template <class E, bool kChunked>
__global__ void __launch_bounds__(kMaxThreads)
lstm_seq_bwd_kernel(const float* __restrict__ dout,   // (T, B, H)
                    const E* __restrict__ proj,       // (T, B, 4H)
                    const E* __restrict__ hprev,      // (T, B, H)
                    const float* __restrict__ cprev,  // (T, B, H)
                    const float* __restrict__ cs,     // (T, B, H)
                    const E* __restrict__ wh,         // (H, 4H)
                    const float* __restrict__ dcT,    // (B, H)
                    const int* __restrict__ burn,     // (B,)
                    float* dz,      // (T, B, 4H); float: read back by other blocks
                    E* xch,         // bf16: (2, B, 4H) exchange ring; float: unused
                    float* carry,   // more than one chunk: (2, grid, chunks*Bc, Hb)
                    int* bar,       // (2,) grid barrier, zeroed
                    int T, int B, int H, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  Walk<E, kChunked> w(smem, wh, dcT, burn, B, H, Hb, kt, pinned, Bc, carry);
  const size_t BH = (size_t)B * H;
  for (int t = T - 1; t >= 0; --t) {
    float* dz_t = dz + t * 4 * BH;
    E* x_t;  // what the blocks exchange: dz_t itself, or bf16(dz_t)
    if constexpr (kF32<E>)
      x_t = dz_t;
    else
      x_t = xch + (t & 1) * 4 * BH;
    for (int c = 0; c < w.n_chunks(); ++c)
      w.template dz_step<true>(t, c, dout + t * BH, proj + t * 4 * BH, hprev + t * BH,
                               cprev + t * BH, cs + t * BH, x_t, dz_t);
    if (t == 0) break;  // the carry out of step 0 is not wanted
    grid_barrier(bar);  // x_t complete before anyone reads it
    for (int c = 0; c < w.n_chunks(); ++c) {
      float a[4][4];
      w.carry_product(a, x_t, c);
      w.template store_carry<true>(a, t, c);
    }
  }
}

template <class E>
int launch(const float* dout, const E* proj, const E* hprev, const float* cprev, const float* cs,
           const E* wh, const float* dcT, const int* burn, float* dz, E* xch, float* carry,
           int* bar, int T, int B, int H, int Hb, int grid, int threads, int kt, int pinned,
           int smem, int Bc, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(
      B > Bc ? lstm_seq_bwd_kernel<E, true> : lstm_seq_bwd_kernel<E, false>, grid, threads, smem,
      stream, dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, xch, carry, bar, T, B, H, Hb, kt,
      pinned, Bc);
}

}  // namespace

extern "C" int lstm_seq_bwd_launch(const float* dout, const float* proj, const float* hprev,
                                   const float* cprev, const float* cs, const float* wh,
                                   const float* dcT, const int* burn, float* dz, float* xch,
                                   float* carry, int* bar, int T, int B, int H, int Hb, int grid,
                                   int threads, int kt, int pinned, int smem, int Bc,
                                   void* stream) {
  return launch(dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, xch, carry, bar, T, B, H, Hb,
                grid, threads, kt, pinned, smem, Bc, stream);
}

extern "C" int lstm_seq_bwd_bf16_launch(const float* dout, const bf16* proj, const bf16* hprev,
                                        const float* cprev, const float* cs, const bf16* wh,
                                        const float* dcT, const int* burn, float* dz, bf16* xch,
                                        float* carry, int* bar, int T, int B, int H, int Hb,
                                        int grid, int threads, int kt, int pinned, int smem,
                                        int Bc, void* stream) {
  return launch(dout, proj, hprev, cprev, cs, wh, dcT, burn, dz, xch, carry, bar, T, B, H, Hb,
                grid, threads, kt, pinned, smem, Bc, stream);
}

extern "C" const char* lstm_seq_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
