// Fused T-step LSTM forward for Hopper (sm_90a), in float32 and in bf16.
//
// Replaces the TPU kernel `_fwd_kernel` / `_lstm_fwd_call` of
// r2d2_tpu/ops/pallas_lstm.py. Per step t, for every batch row:
//     z = proj_t[t] + h_{t-1} @ wh        (f32 accumulate)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of z's four H-wide slices
//     c_t = f * c_{t-1} + i * g;   h_t = o * tanh(c_t)
// writing outs[t] = h_t and cs[t] = c_t. The (h, c) carry stays in f32.
// The bf16 form (lstm_fwd_bf16_launch) takes proj, wh, h0 and c0 in bf16
// and writes outs in bf16, as the Pallas kernel does under bf16 compute:
// the product sums exact products of bf16 values in f32, and h_t is
// rounded to bf16 once, for outs[t] and for step t+1's product alike
// (the Pallas kernel's h_s.astype(wh.dtype) of the f32 h it keeps).
//
// What bounds it on this card. The work is 2*T*B*H*4H FMA-flops of a
// strictly sequential recurrence; at the atari widths (T=85, B=64, H=512)
// that is 11.4 GFLOP against about 71 MB of device-memory traffic, so the
// least possible time is set by the fp32 rate. Each step depends on the
// whole of the previous step's h, so the real floor is T steps of
// (product spread over the SMs + one exchange of h + one grid barrier).
//
// What the design does about it (column_split.cuh): the hidden units are
// split across a persistent cooperative grid of about one block per SM,
// each block owning Hb units, their four gate columns of wh (pinned in
// shared memory where they fit: 32 KB at H=512; streamed in k-tiles at
// H=2048) and all B rows. Per step a block reads all of h_{t-1} (B x H)
// through L2, computes its B x 4Hb gates, applies the nonlinearities
// locally (its c carry never leaves the thread), writes outs[t] and cs[t],
// and meets the grid at one barrier. A batch wider than one chunk of rows
// is walked in chunks inside each step; the c carry of a chunk is then
// read back from cs[t-1], which the same threads wrote.
//
// The exchange. Besides outs[t], each block writes its units' h_t into a
// two-step ring xch (a block may still read step t's while another writes
// step t+1's) in the tiled layout the stage buffers hold (ExchangeRing:
// per chunk, tile by tile over H, Bc rows of kt + kVec a tile), so that
// after the grid barrier one thread brings each k-tile in by one TMA bulk
// copy into the kStages stage buffers, each stage with a full and an
// empty mbarrier (column_split.cuh, GateRing and ring_tiles): no thread
// spends registers or copies on it and no block barrier runs per tile.
// Where wh is streamed, each block first lays out its gate columns the
// same way, once (tile_cols), and a second bulk copy brings a tile's. h0
// is laid out into the ring before the first step, behind one more grid
// barrier. The tiles come in the cp.async pipeline's order with the same
// geometry, so every sum keeps its order and outs and cs their bits.
// The stage ring's barriers take the first 16 bytes a stage of the
// shared memory (lstm_kernel.lstm_geometry counts them).
//
// Also here: a kernel that only runs n grid barriers with the same
// geometry, the floor of this design, and one that runs the exchange
// alone (lstm_fwd_exchange_launch), both timed by chip_smoke.py;
// lstm_fwd_exchange_ring_elems sizes the ring.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

// The forward's shared memory: the stage ring's barriers (two a stage),
// the gate columns (pinned: H x 4Hb; streamed: kStages kt x 4Hb tiles;
// bf16: in the tensor-core layout, rows of wc_ld_tc(Hb), pinned padded
// with zero rows to a multiple of 16), kStages Bc x (kt + kVec) staging
// tiles of h, and the slices' partials (bf16: their planes of sums)
template <class E>
struct FwdSmem {
  uint64_t* bars;
  E *wc, *st;
  float* red;
  __device__ __forceinline__ FwdSmem(float* smem, int H, int Hb, int kt, int pinned, int Bc) {
    const int wc_elems = kF32<E> ? (pinned ? H : kStages * kt) * 4 * Hb
                                 : (pinned ? (H + 15) & ~15 : kStages * kt) * wc_ld_tc(Hb);
    const int st_elems = kStages * Bc * (kt + kVec<E>);
    bars = reinterpret_cast<uint64_t*>(smem);
    wc = reinterpret_cast<E*>(bars + 2 * kStages);
    st = wc + wc_elems;
    red = reinterpret_cast<float*>(st + st_elems);
    zero_smem(reinterpret_cast<float*>(wc), (wc_elems + st_elems) * (int)sizeof(E));
    ring_init(stages());
  }
  __device__ __forceinline__ auto stages() const {
    uint64_t* b = bars;
    return [b](int s) { return b + 2 * s; };
  }
};

template <class E, bool kChunked>
__global__ void __launch_bounds__(kTensorCoreFormThreads<E>)
lstm_fwd_kernel(const E* __restrict__ proj,  // (T, B, 4H)
                const E* __restrict__ wh,    // (H, 4H)
                const E* __restrict__ h0,    // (B, H)
                const E* __restrict__ c0,    // (B, H)
                E* __restrict__ outs,        // (T, B, H)
                float* __restrict__ cs,      // (T, B, H)
                E* xch,   // the exchange ring (ExchangeRing); read back by other blocks
                int* bar,                    // (2,) grid barrier, zeroed
                int T, int B, int H, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * Hb;
  const int n_units = imin(Hb, H - j0);
  const int nrg = Bc / 4, chunks = kChunked ? (B + Bc - 1) / Bc : 1;
  const FwdSmem<E> sm(smem, H, Hb, kt, pinned, Bc);
  const ExchangeRing<E> ring(B, H, Hb, kt, pinned, Bc, false, true);
  E* hx = xch + ring.h_at();  // h_t in slot (t + 1) & 1, h0 in slot 0
  const E* wt = xch + ring.wc_at(blockIdx.x);
  int pos = 0;
  const Item it(nrg, Hb);
  // the owner's outputs: rows rg + r*nrg of unit j (clamped for the loads
  // of padding rows and units, whose results are never stored)
  const int j = j0 + imin(it.col, n_units - 1);
  const bool unit_ok = it.col < n_units;
  int row[4];
  float c[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    row[r] = imin(it.rg + r * nrg, B - 1);
    c[r] = to_f32(__ldg(c0 + (size_t)row[r] * H + j));
  }
  if (pinned) {
    if constexpr (kF32<E>)
      load_cols(sm.wc, wh, H, j0, n_units, Hb, 0, H);
    else
      copy_cols_tc(sm.wc, wc_ld_tc(Hb), wh, H, j0, n_units, Hb, 0, H);
    copies_commit();
    copies_wait<0>();
  } else {
    tile_cols(xch + ring.wc_at(blockIdx.x), wh, H, j0, n_units, Hb, kt);
  }
  tile_h(hx, ring, h0, B, H, j0, n_units);
  zero_h_padding(hx, ring, B, H);
  grid_barrier(bar);  // h0's tiles (and the barriers) complete before anyone reads them

  for (int t = 0; t < T; ++t) {
    const E* x = hx + (t & 1) * ring.h_step();
    E* next = hx + ((t + 1) & 1) * ring.h_step();
    for (int q = 0; q < chunks; ++q) {
      const int r0 = kChunked ? q * Bc : 0;
      if constexpr (kChunked) {  // this chunk's rows, and its c carry from cs[t-1]
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          row[r] = imin(r0 + it.rg + r * nrg, B - 1);
          const size_t o = (size_t)row[r] * H + j;
          c[r] = t == 0 ? to_f32(__ldg(c0 + o)) : __ldcg(cs + (size_t)(t - 1) * B * H + o);
        }
      }
      // the step's input projections, loaded before the product hides them
      float z[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const E* p = proj + ((size_t)t * B + row[r]) * 4 * H + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[r][g] = it.owner() ? to_f32(__ldg(p + g * H)) : 0.0f;
      }
      float acc[4][4];
      gates(acc,
            gate_ring(x + q * ring.h_chunk(), wt, sm.wc, sm.st, imin(Bc, B - r0), Bc, H, Hb, kt,
                      pinned, sm.stages(), pos),
            sm.wc, sm.st, sm.red, it, Bc, H, Hb, kt, pinned);
      if (it.owner() && unit_ok) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ig = sigmoid_f32(z[r][0] + acc[r][0]);
          const float fg = sigmoid_f32(z[r][1] + acc[r][1]);
          const float gg = tanhf(z[r][2] + acc[r][2]);
          const float og = sigmoid_f32(z[r][3] + acc[r][3]);
          c[r] = fg * c[r] + ig * gg;
          if (r0 + it.rg + r * nrg >= B) continue;
          const size_t o = ((size_t)t * B + row[r]) * H + j;
          const E h = from_f32<E>(og * tanhf(c[r]));
          outs[o] = h;
          cs[o] = c[r];
          if (t + 1 < T) next[ring.h_pos(row[r], j)] = h;  // the last h is not exchanged
        }
      }
    }
    if (t + 1 < T) grid_barrier(bar);  // h_t complete before anyone reads it
  }
}

__global__ void grid_barriers_kernel(int* bar, int n) {
  for (int i = 0; i < n; ++i) grid_barrier(bar);
}

// The exchange alone, for timing: T - 1 steps of one grid barrier and the
// gate product's exchange of h (B, H) into the stage buffers, with no
// product (kBulk: the bulk ring, x an exchange ring (ExchangeRing), its
// first slot exchanged; else the cp.async pipeline, x (B, H) rows), in the
// forward's geometry with the batch in one chunk; with `cols`, the
// block's gate columns come beside each tile where wh is streamed.
template <class E, bool kBulk>
__global__ void __launch_bounds__(kTensorCoreFormThreads<E>)
exchange_kernel(E* x, const E* __restrict__ wh, int* bar, int T, int B, int H, int Hb, int kt,
                int pinned, int Bc, int cols) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * Hb, n_units = imin(Hb, H - j0);
  const FwdSmem<E> sm(smem, H, Hb, kt, pinned, Bc);
  const ExchangeRing<E> ring(B, H, Hb, kt, pinned, Bc, false, true);
  const int copy_cols = pinned || !cols;  // the product's `pinned`: no columns copied
  int pos = 0;
  if constexpr (kBulk) {
    if (!copy_cols) tile_cols(x + ring.wc_at(blockIdx.x), wh, H, j0, n_units, Hb, kt);
  }
  __syncthreads();
  for (int t = T - 1; t > 0; --t) {
    grid_barrier(bar);
    if constexpr (kBulk)
      gate_ring(x + ring.h_at(), x + ring.wc_at(blockIdx.x), sm.wc, sm.st, B, Bc, H, Hb, kt,
                copy_cols, sm.stages(), pos)([](int, int) {});
    else
      GateRows<E>{x, wh, sm.wc, sm.st, B, Bc, H, Hb, j0, n_units, kt, copy_cols}([](int, int) {});
  }
}

template <class E>
int launch(const E* proj, const E* wh, const E* h0, const E* c0, E* outs, float* cs, E* xch,
           int* bar, int T, int B, int H, int Hb, int grid, int threads, int kt, int pinned,
           int smem, int Bc, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(B > Bc ? lstm_fwd_kernel<E, true> : lstm_fwd_kernel<E, false>,
                                 grid, threads, smem, stream, proj, wh, h0, c0, outs, cs, xch, bar,
                                 T, B, H, Hb, kt, pinned, Bc);
}

template <class E>
int launch_exchange(int bulk, int cols, E* x, const E* wh, int* bar, int T, int B, int H, int Hb,
                    int grid, int threads, int kt, int pinned, int smem, int Bc, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (B > Bc) return (int)cudaErrorInvalidValue;  // one chunk
  return (int)launch_cooperative(bulk ? exchange_kernel<E, true> : exchange_kernel<E, false>,
                                 grid, threads, smem, stream, x, wh, bar, T, B, H, Hb, kt, pinned,
                                 Bc, cols);
}

}  // namespace

extern "C" int lstm_fwd_launch(const float* proj, const float* wh, const float* h0,
                               const float* c0, float* outs, float* cs, float* xch, int* bar,
                               int T, int B, int H, int Hb, int grid, int threads, int kt,
                               int pinned, int smem, int Bc, void* stream) {
  return launch(proj, wh, h0, c0, outs, cs, xch, bar, T, B, H, Hb, grid, threads, kt, pinned,
                smem, Bc, stream);
}

extern "C" int lstm_fwd_bf16_launch(const bf16* proj, const bf16* wh, const bf16* h0,
                                    const bf16* c0, bf16* outs, float* cs, bf16* xch, int* bar,
                                    int T, int B, int H, int Hb, int grid, int threads, int kt,
                                    int pinned, int smem, int Bc, void* stream) {
  return launch(proj, wh, h0, c0, outs, cs, xch, bar, T, B, H, Hb, grid, threads, kt, pinned,
                smem, Bc, stream);
}

// n grid barriers and nothing else, with a forward launch's grid, threads
// and shared memory: the per-step floor of the column split.
extern "C" int lstm_fwd_barriers_launch(int* bar, int n, int grid, int threads, int smem,
                                        void* stream) {
  return (int)launch_cooperative(grid_barriers_kernel, grid, threads, smem, stream, bar, n);
}

// The exchange alone (exchange_kernel): bulk 1 the bulk ring (x a ring of
// lstm_fwd_exchange_ring_elems), 0 the cp.async pipeline (x (B, H), or
// larger); cols 1 with wh's gate columns where streamed; wh (H, 4H) and a
// zeroed barrier, with the forward's geometry, the batch in one chunk
// (else cudaErrorInvalidValue).
extern "C" int lstm_fwd_exchange_launch(float* x, const float* wh, int* bar, int T, int B, int H,
                                        int Hb, int grid, int threads, int kt, int pinned,
                                        int smem, int Bc, int bulk, int cols, void* stream) {
  return launch_exchange(bulk, cols, x, wh, bar, T, B, H, Hb, grid, threads, kt, pinned, smem, Bc,
                         stream);
}

extern "C" int lstm_fwd_exchange_bf16_launch(bf16* x, const bf16* wh, int* bar, int T, int B,
                                             int H, int Hb, int grid, int threads, int kt,
                                             int pinned, int smem, int Bc, int bulk, int cols,
                                             void* stream) {
  return launch_exchange(bulk, cols, x, wh, bar, T, B, H, Hb, grid, threads, kt, pinned, smem, Bc,
                         stream);
}

// The exchange ring's elements (xch, of `itemsize`-byte values) at the
// forward's geometry (column_split.cuh ExchangeRing: the gate product's
// exchange only)
extern "C" long long lstm_fwd_exchange_ring_elems(int itemsize, int B, int H, int Hb, int grid,
                                                  int kt, int pinned, int Bc) {
  return exchange_ring_elems(itemsize, B, H, Hb, grid, kt, pinned, Bc, false, true);
}

extern "C" const char* lstm_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
