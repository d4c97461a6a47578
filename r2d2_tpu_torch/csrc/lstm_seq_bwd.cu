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
// bf16 is what the blocks exchange (in the two-step ring xch, as the f32
// dz_t is in float32; see "The exchange" below). It runs both
// products on the tensor cores (column_split.cuh, mma.sync m16n8k16, bf16
// operands summed in f32), as the bf16 forms of K1, K3, K4 and K5 do.
//
// What bounds it on this card. Each (row, step) does two H x 4H products:
// the gate recompute and the carry. At the atari widths that is about
// 22.8 GFLOP against about 140 MB of device-memory traffic (about 110 MB
// in bf16), so the least time is set by the fp32 rate in float32 and, in
// bf16, by the bytes (at the tensor cores' rate the products take about
// 0.023 ms, the bytes 0.032); the sequential floor is T steps of one
// exchange of dz_t and one grid barrier, each a block's read of the
// whole exchanged dz_t through L2.
//
// What the design does about it: the column split's reverse walk
// (column_split.cuh, Walk), one grid barrier per step. Block x owns Hb
// hidden units, their four gate columns of wh (for the recompute) and their
// Hb rows of wh (for the carry), pinned in shared memory where they fit
// (32 KB each at H=512) or streamed in k-tiles (H=2048), and all B rows;
// each writes its columns of dz[t] and of the exchange ring, which every
// block reads whole after the barrier. The (dh, dc) carry of the
// block's units never leaves the SM. No wh^T copy is needed: the carry
// reads wh's rows. A batch wider than one chunk of rows is walked in
// chunks inside each step, the carry then kept in the block's slabs of
// `carry`. The bf16 form takes K4's bf16 split (lstm_kernel.lstm_geometry),
// so that K4's bf16 dz is this form's f32 dz rounded, bit for bit.
//
// The exchange. Each step every block reads the whole exchanged dz_t (B x
// 4H; 512 KB in float32, 256 KB in bf16 at the atari widths) through L2,
// four times the bytes of the forward's h_t, so the exchange, not the
// products or the barrier, held the step. The carry product takes it
// through the bulk ring (column_split.cuh, "The exchange"): dz_t is
// written in the ring xch (a two-step ring: a block may still read step
// t's while another writes step t-1's) tile by tile, each tile laid out
// as the stage buffer holds it, so one thread issues one TMA bulk copy a
// tile into the kStages stage buffers, each stage with a full and an empty
// mbarrier: no thread spends registers or a copy group on it and no block
// barrier runs per tile. Where wh is streamed, each block lays out its
// rows of wh the same way once, and a second bulk copy brings a tile's.
// Each block multiplies its tiles in the cp.async walk's order, so the
// bits are those of that walk; K4 (lstm_seq_bwd_fused.cu) walks on the
// same ring. lstm_seq_bwd_exchange_launch runs
// the exchange alone, for timing; lstm_seq_bwd_exchange_ring_elems sizes
// the ring.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

template <class E, bool kChunked>
__global__ void __launch_bounds__(kTensorCoreFormThreads<E>)
lstm_seq_bwd_kernel(const float* __restrict__ dout,   // (T, B, H)
                    const E* __restrict__ proj,       // (T, B, 4H)
                    const E* __restrict__ hprev,      // (T, B, H)
                    const float* __restrict__ cprev,  // (T, B, H)
                    const float* __restrict__ cs,     // (T, B, H)
                    const E* __restrict__ wh,         // (H, 4H)
                    const float* __restrict__ dcT,    // (B, H)
                    const int* __restrict__ burn,     // (B,)
                    float* dz,      // (T, B, 4H)
                    E* xch,         // the exchange ring (ExchangeRing)
                    float* carry,   // more than one chunk: (2, grid, chunks*Bc, Hb)
                    int* bar,       // (2,) grid barrier, zeroed
                    int T, int B, int H, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  // bf16: both products on the tensor cores (Walk::kTC)
  Walk<E, kChunked, true> w(smem, wh, dcT, burn, B, H, Hb, kt, pinned, Bc, carry);
  w.tile_wh(xch);  // where wh is streamed
  const size_t BH = (size_t)B * H;
  for (int t = T - 1; t >= 0; --t) {
    float* dz_t = dz + t * 4 * BH;
    // what the blocks exchange: dz_t (bf16: rounded), in the two-step ring
    // (a block may still read step t's while another writes step t-1's)
    E* x_t = w.exchange_at(xch, t);
    E* rows = nullptr;  // the dz output: float, rows of E; bf16, the f32 copy
    if constexpr (kF32<E>) rows = dz_t;
    for (int c = 0; c < w.n_chunks(); ++c)
      w.template dz_step<true>(t, c, dout + t * BH, proj + t * 4 * BH, hprev + t * BH,
                               cprev + t * BH, cs + t * BH, rows, kF32<E> ? nullptr : dz_t,
                               x_t);
    if (t == 0) break;  // the carry out of step 0 is not wanted
    grid_barrier(bar);  // x_t complete before anyone reads it
    for (int c = 0; c < w.n_chunks(); ++c) {
      float a[4][4];
      w.carry_product(a, x_t, c);
      w.template store_carry<true>(a, t, c);
    }
  }
}

// The exchange alone, for timing: the walk's T - 1 steps of one grid
// barrier and the carry product's exchange of x (B, 4H) into the stage
// ring, with no product (kBulk: the bulk ring, x an exchange ring
// (ExchangeRing), its first slot exchanged; else the cp.async pipeline,
// x (B, 4H) rows), in the seam backward's geometry with the batch in one
// chunk.
template <class E, bool kBulk>
__global__ void __launch_bounds__(kTensorCoreFormThreads<E>)
exchange_kernel(E* x, const E* __restrict__ wh, const float* __restrict__ dcT, int* bar, int T,
                int B, int H, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  Walk<E, false, kBulk> w(smem, wh, dcT, nullptr, B, H, Hb, kt, pinned, Bc, nullptr);
  if constexpr (kBulk) w.tile_wh(x);
  copies_commit();  // the pinned slices of wh, which no gate product waits for here
  copies_wait<0>();
  __syncthreads();
  for (int t = T - 1; t > 0; --t) {
    grid_barrier(bar);
    w.exchange(w.chunk_of(x, 0), B, [](int, int) {});
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

template <class E>
int launch_exchange(int bulk, E* x, const E* wh, const float* dcT, int* bar, int T, int B, int H,
                    int Hb, int grid, int threads, int kt, int pinned, int smem, int Bc,
                    void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (B > Bc) return (int)cudaErrorInvalidValue;  // one chunk
  return (int)launch_cooperative(bulk ? exchange_kernel<E, true> : exchange_kernel<E, false>,
                                 grid, threads, smem, stream, x, wh, dcT, bar, T, B, H, Hb, kt,
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

// The exchange alone (exchange_kernel): bulk 1 the bulk ring (x a ring of
// lstm_seq_bwd_exchange_ring_elems), 0 the cp.async pipeline (x (B, 4H),
// or larger); wh (H, 4H), dcT (B, H) and a zeroed barrier, with the seam
// backward's geometry, the batch in one chunk (else cudaErrorInvalidValue).
extern "C" int lstm_seq_bwd_exchange_launch(float* x, const float* wh, const float* dcT, int* bar,
                                            int T, int B, int H, int Hb, int grid, int threads,
                                            int kt, int pinned, int smem, int Bc, int bulk,
                                            void* stream) {
  return launch_exchange(bulk, x, wh, dcT, bar, T, B, H, Hb, grid, threads, kt, pinned, smem, Bc,
                         stream);
}

extern "C" int lstm_seq_bwd_exchange_bf16_launch(bf16* x, const bf16* wh, const float* dcT,
                                                 int* bar, int T, int B, int H, int Hb, int grid,
                                                 int threads, int kt, int pinned, int smem,
                                                 int Bc, int bulk, void* stream) {
  return launch_exchange(bulk, x, wh, dcT, bar, T, B, H, Hb, grid, threads, kt, pinned, smem, Bc,
                         stream);
}

// The exchange ring's elements (xch, of `itemsize`-byte values) at the
// seam backward's geometry (column_split.cuh ExchangeRing)
extern "C" long long lstm_seq_bwd_exchange_ring_elems(int itemsize, int B, int H, int Hb,
                                                      int grid, int kt, int pinned, int Bc) {
  return exchange_ring_elems(itemsize, B, H, Hb, grid, kt, pinned, Bc, true, false);
}

extern "C" const char* lstm_seq_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
