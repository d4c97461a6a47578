// Reverse-time LSTM backward with the per-row burn-in seam, for Hopper
// (sm_90a), float32.
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
// What bounds it on this card. Each (row, step) does two H x 4H products:
// the gate recompute and the carry. At the atari widths that is about
// 22.8 GFLOP against about 140 MB of device-memory traffic, so the least
// time is set by the fp32 rate; the sequential floor is T steps of one
// exchange of dz_t and one grid barrier.
//
// What the design does about it (column_split.cuh): the forward kernel's
// column split. Block x owns Hb hidden units, their four gate columns of
// wh (for the recompute) and their Hb rows of wh (for the carry), both
// pinned in shared memory where they fit (32 KB each at H=512) or streamed
// in k-tiles (H=2048), and all B rows. Per step t:
//   1. recompute the block's B x 4Hb gates from hprev[t] (a residual);
//   2. form dz[t] for its columns from its (dh, dc) carry, masks per row,
//      and write it: dz is both the output and the exchange buffer;
//   3. one grid barrier;
//   4. read the whole dz[t] (B x 4H) through L2 and form dh for its own
//      units against its rows of wh.
// The (dh, dc) carry of the block's units never leaves the SM, so one
// barrier per step is enough. No wh^T copy is needed: the carry reads
// wh's rows directly.

#include <cuda_runtime.h>

#include "column_split.cuh"

namespace {

using namespace colsplit;

__global__ void __launch_bounds__(kMaxThreads)
lstm_seq_bwd_kernel(const float* __restrict__ dout,   // (T, B, H)
                    const float* __restrict__ proj,   // (T, B, 4H)
                    const float* __restrict__ hprev,  // (T, B, H)
                    const float* __restrict__ cprev,  // (T, B, H)
                    const float* __restrict__ cs,     // (T, B, H)
                    const float* __restrict__ wh,     // (H, 4H)
                    const float* __restrict__ dcT,    // (B, H)
                    const int* __restrict__ burn,     // (B,)
                    float* dz,  // (T, B, 4H); read back by other blocks: not restrict
                    int* bar,   // (2,) grid barrier, zeroed
                    int T, int B, int H, int Hb, int kt, int pinned) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  const int j0 = blockIdx.x * Hb;
  const int n_units = imin(Hb, H - j0);
  const int Bp = (B + 3) & ~3, nrg = Bp / 4;
  const int Hbp = (Hb + 3) & ~3;  // units padded to groups of four for the carry
  const int ld = kt + kPad;
  // the gate columns (pinned: H x 4Hb; streamed: kStages kt x 4Hb tiles);
  // the block's rows of wh, wr[u][m] = wh[j0 + u, m], Hbp rows of wr_ld
  // floats (pinned: all 4H columns; streamed: kStages tiles of kt); the
  // kStages Bp x (kt + kPad) staging tiles (of h for the recompute, of dz
  // for the carry); the dh carry, dh_s[row][unit]; the slices' partials
  const int wr_ld = (pinned ? H4 : kt) + kPad;
  const int wc_floats = (pinned ? H : kStages * kt) * 4 * Hb;
  const int wr_floats = (pinned ? 1 : kStages) * Hbp * wr_ld;
  const int st_floats = kStages * Bp * ld;
  float* wc = smem;
  float* wr = wc + wc_floats;
  float* st = wr + wr_floats;
  float* dh_s = st + st_floats;  // Bp x Hb; 0: the h_T cotangent is folded into dout[T-1]
  float* red = dh_s + Bp * Hb;
  zero_smem(smem, wc_floats + wr_floats + st_floats + Bp * Hb);
  const Item it(nrg, Hb);          // the gate product's items: 4 rows x 1 unit
  const Item ic(nrg, Hbp / 4);     // the carry product's: 4 rows x 4 units
  const int j = j0 + imin(it.col, n_units - 1);
  const bool unit_ok = it.col < n_units;
  int row[4], seam[4];
  float dc[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    row[r] = imin(it.rg + r * nrg, B - 1);
    seam[r] = __ldg(burn + row[r]);
    dc[r] = __ldg(dcT + (size_t)row[r] * H + j);
  }
  if (pinned) {  // lands with the first tile
    load_cols(wc, wh, H, j0, n_units, Hb, 0, H);
    stage_rows(wr, wr_ld, wh + (size_t)j0 * H4, H4, n_units, 0, H4);
  }

  for (int t = T - 1; t >= 0; --t) {
    // the step's saved inputs (owners only), loaded before the product hides them
    float z[4][4], d_out[4], c_t[4], c_prev[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const size_t o = ((size_t)t * B + row[r]) * H + j;
      const bool load = it.owner();
#pragma unroll
      for (int g = 0; g < 4; ++g) z[r][g] = load ? __ldg(proj + 4 * (o - j) + g * H + j) : 0.0f;
      d_out[r] = load && t >= seam[r] ? __ldg(dout + o) : 0.0f;
      c_t[r] = load ? __ldg(cs + o) : 0.0f;
      c_prev[r] = load ? __ldg(cprev + o) : 0.0f;
    }
    // 1. the gates, recomputed from h_{t-1}
    float acc[4][4];
    gate_product(acc, hprev + (size_t)t * B * H, wh, wc, st, red, it, B, Bp, H, Hb, j0,
                 n_units, kt, pinned);
    // 2. this block's columns of dz[t]
    if (it.owner()) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ig = sigmoid_f32(z[r][0] + acc[r][0]);
        const float fg = sigmoid_f32(z[r][1] + acc[r][1]);
        const float gg = tanhf(z[r][2] + acc[r][2]);
        const float og = sigmoid_f32(z[r][3] + acc[r][3]);
        const float tc = tanhf(c_t[r]);
        const float dht = d_out[r] + dh_s[(it.rg + r * nrg) * Hb + it.col];
        const float d_o = dht * tc;
        const float dct = dht * og * (1.0f - tc * tc) + dc[r];
        const float di = dct * gg;
        const float df = dct * c_prev[r];
        const float dg = dct * ig;
        dc[r] = (t > seam[r]) ? dct * fg : 0.0f;
        if (!unit_ok || it.rg + r * nrg >= B) continue;
        float* out = dz + ((size_t)t * B + row[r]) * H4 + j;
        out[0] = di * ig * (1.0f - ig);
        out[H] = df * fg * (1.0f - fg);
        out[2 * H] = dg * (1.0f - gg * gg);
        out[3 * H] = d_o * og * (1.0f - og);
      }
    }
    if (t == 0) break;  // the carry out of step 0 is not wanted
    grid_barrier(bar);  // dz[t] complete before anyone reads it
    // 4. dh[row, j] = sum_m dz[t, row, m] * wh[j, m], over 4H in m-tiles
    float a[4][4];  // rows x the item's four units
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r][0] = a[r][1] = a[r][2] = a[r][3] = 0.0f;
    const float* dzt = dz + (size_t)t * B * H4;
    const int n = (H4 + kt - 1) / kt;
    pipelined_tiles(
        n, blockIdx.x % n,
        [&](int c, int buf) {
          const int m0 = c * kt, mn = imin(kt, H4 - m0);
          stage_rows(st + buf * Bp * ld, ld, dzt, H4, B, m0, mn);
          if (!pinned)
            stage_rows(wr + buf * Hbp * wr_ld, wr_ld, wh + (size_t)j0 * H4, H4, n_units, m0, mn);
        },
        [&](int c, int buf) {
          if (ic.slice >= ic.ks) return;
          const int m0 = c * kt, mn = imin(kt, H4 - m0);
          const float* s = st + buf * Bp * ld + ic.rg * ld;
          const float* w = (pinned ? wr + m0 : wr + buf * Hbp * wr_ld) + 4 * ic.col * wr_ld;
          for (int m = 4 * ic.slice; m < mn; m += 4 * ic.ks) {
            float4 d[4], w4[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) d[r] = *reinterpret_cast<const float4*>(s + r * nrg * ld + m);
#pragma unroll
            for (int u = 0; u < 4; ++u) w4[u] = *reinterpret_cast<const float4*>(w + u * wr_ld + m);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                a[r][u] = fmaf(d[r].x, w4[u].x, a[r][u]);
                a[r][u] = fmaf(d[r].y, w4[u].y, a[r][u]);
                a[r][u] = fmaf(d[r].z, w4[u].z, a[r][u]);
                a[r][u] = fmaf(d[r].w, w4[u].w, a[r][u]);
              }
            }
          }
        });
    reduce_slices(a, red, ic);
    if (ic.owner()) {  // the masked carry into step t-1
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = ic.rg + r * nrg;
        const bool keep = rr < B && t > __ldg(burn + imin(rr, B - 1));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int uu = 4 * ic.col + u;
          if (uu < Hb) dh_s[rr * Hb + uu] = keep ? a[r][u] : 0.0f;
        }
      }
    }
  }
}

}  // namespace

extern "C" int lstm_seq_bwd_launch(const float* dout, const float* proj, const float* hprev,
                                   const float* cprev, const float* cs, const float* wh,
                                   const float* dcT, const int* burn, float* dz, int* bar,
                                   int T, int B, int H, int Hb, int grid, int threads, int kt,
                                   int pinned, int smem, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  return (int)launch_cooperative(lstm_seq_bwd_kernel, grid, threads, smem, stream, dout, proj,
                                 hprev, cprev, cs, wh, dcT, burn, dz, bar, T, B, H, Hb, kt,
                                 pinned);
}

extern "C" const char* lstm_seq_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
