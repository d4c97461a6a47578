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
// and meets the grid at one barrier. outs[t] is the exchange buffer for
// step t+1: no other scratch. A batch wider than one chunk of rows is
// walked in chunks inside each step; the c carry of a chunk is then read
// back from cs[t-1], which the same threads wrote.
//
// Also here: a kernel that only runs n grid barriers with the same
// geometry, the floor of this design, timed by chip_smoke.py.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

template <class E, bool kChunked>
__global__ void __launch_bounds__(kTensorCoreFormThreads<E>)
lstm_fwd_kernel(const E* __restrict__ proj,  // (T, B, 4H)
                const E* __restrict__ wh,    // (H, 4H)
                const E* __restrict__ h0,    // (B, H)
                const E* __restrict__ c0,    // (B, H)
                E* outs,  // (T, B, H); read back by other blocks: not restrict
                float* __restrict__ cs,      // (T, B, H)
                int* bar,                    // (2,) grid barrier, zeroed
                int T, int B, int H, int Hb, int kt, int pinned, int Bc) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * Hb;
  const int n_units = imin(Hb, H - j0);
  const int nrg = Bc / 4, chunks = kChunked ? (B + Bc - 1) / Bc : 1;
  // the gate columns (pinned: H x 4Hb; streamed: kStages kt x 4Hb tiles;
  // bf16: in the tensor-core layout, rows of wc_ld_tc(Hb), pinned padded
  // with zero rows to a multiple of 16), kStages Bc x (kt + kVec) staging
  // tiles of h, and the slices' partials (bf16: their planes of sums)
  const int wc_elems = kF32<E> ? (pinned ? H : kStages * kt) * 4 * Hb
                               : (pinned ? (H + 15) & ~15 : kStages * kt) * wc_ld_tc(Hb);
  const int st_elems = kStages * Bc * (kt + kVec<E>);
  E* wc = reinterpret_cast<E*>(smem);
  E* st = wc + wc_elems;
  float* red = reinterpret_cast<float*>(st + st_elems);
  zero_smem(smem, (wc_elems + st_elems) * (int)sizeof(E));
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
  if (pinned) {  // lands with the first tile
    if constexpr (kF32<E>)
      load_cols(wc, wh, H, j0, n_units, Hb, 0, H);
    else
      copy_cols_tc(wc, wc_ld_tc(Hb), wh, H, j0, n_units, Hb, 0, H);
  }

  for (int t = 0; t < T; ++t) {
    const E* h = t == 0 ? h0 : outs + (size_t)(t - 1) * B * H;
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
      if constexpr (kF32<E>)
        gate_product(acc, h + (size_t)r0 * H, wh, wc, st, red, it, imin(Bc, B - r0), Bc, H, Hb,
                     j0, n_units, kt, pinned);
      else  // on the tensor cores
        gate_product_tc(acc, h + (size_t)r0 * H, wh, wc, st, red, it, imin(Bc, B - r0), Bc, H,
                        Hb, j0, n_units, kt, pinned);
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
          outs[o] = from_f32<E>(og * tanhf(c[r]));
          cs[o] = c[r];
        }
      }
    }
    if (t + 1 < T) grid_barrier(bar);  // h_t complete before anyone reads it
  }
}

__global__ void grid_barriers_kernel(int* bar, int n) {
  for (int i = 0; i < n; ++i) grid_barrier(bar);
}

template <class E>
int launch(const E* proj, const E* wh, const E* h0, const E* c0, E* outs, float* cs, int* bar,
           int T, int B, int H, int Hb, int grid, int threads, int kt, int pinned, int smem,
           int Bc, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(B > Bc ? lstm_fwd_kernel<E, true> : lstm_fwd_kernel<E, false>,
                                 grid, threads, smem, stream, proj, wh, h0, c0, outs, cs, bar, T,
                                 B, H, Hb, kt, pinned, Bc);
}

}  // namespace

extern "C" int lstm_fwd_launch(const float* proj, const float* wh, const float* h0,
                               const float* c0, float* outs, float* cs, int* bar, int T,
                               int B, int H, int Hb, int grid, int threads, int kt,
                               int pinned, int smem, int Bc, void* stream) {
  return launch(proj, wh, h0, c0, outs, cs, bar, T, B, H, Hb, grid, threads, kt, pinned, smem,
                Bc, stream);
}

extern "C" int lstm_fwd_bf16_launch(const bf16* proj, const bf16* wh, const bf16* h0,
                                    const bf16* c0, bf16* outs, float* cs, int* bar, int T,
                                    int B, int H, int Hb, int grid, int threads, int kt,
                                    int pinned, int smem, int Bc, void* stream) {
  return launch(proj, wh, h0, c0, outs, cs, bar, T, B, H, Hb, grid, threads, kt, pinned, smem,
                Bc, stream);
}

// n grid barriers and nothing else, with a forward launch's grid, threads
// and shared memory: the per-step floor of the column split.
extern "C" int lstm_fwd_barriers_launch(int* bar, int n, int grid, int threads, int smem,
                                        void* stream) {
  return (int)launch_cooperative(grid_barriers_kernel, grid, threads, smem, stream, bar, n);
}

extern "C" const char* lstm_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
