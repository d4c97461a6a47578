// Shared pieces of the column-split LSTM kernels (lstm_fwd.cu, and the
// reverse walk of lstm_seq_bwd.cu, lstm_bwd.cu, lstm_seq_bwd_fused.cu and
// lstm_seq_bwd_ckpt.cu), for Hopper (sm_90a). The element type E of the
// staged rows and of wh is float or __nv_bfloat16; every product is a
// float32 multiply-add of values converted where they are used (a product
// of two bf16 values is exact in float32), and every carry is float32.
//
// The layout. A persistent cooperative grid of about one block per SM.
// Block x owns the hidden units j0 = x*Hb .. j0+n_units-1 and their four
// gate columns (j, H+j, 2H+j, 3H+j) of wh, for all B batch rows. Each step
// ends in one grid barrier, after which every block reads the whole step's
// exchanged rows (h_t in the forward, dz_t in the backward) from global
// memory through L2 only (cp.async.cg: never the non-coherent read-only
// path nor L1, since other blocks wrote them in this launch).
//
// Row chunks. The block walks the batch in chunks of Bc rows (Bc a
// multiple of 4), each staged, multiplied and finished before the next,
// all inside one step: a batch wider than a block's threads or staging
// tiles costs more passes per step, not another launch or barrier. With
// one chunk (Bc = the batch padded to 4) the carries stay on the SM; with
// more, the walk's (dh, dc) carry of the block's units sits in a global
// workspace that only the block touches (and the forward's c carry is
// read back from its own cs output).
//
// The exchanged rows are read in column tiles through a kStages-buffer
// cp.async pipeline, so several tiles' copies fly while one is multiplied;
// each block starts at its own tile (blockIdx modulo the tile count), so
// the SMs do not all ask the same L2 lines at once.
//
// The products are register-tiled, since shared memory, not the FMA
// units, bounds a thread that loads two values per four FMAs. A chunk's
// rows are dealt in row groups: group rg holds rows rg, rg + nrg,
// rg + 2nrg, rg + 3nrg (nrg = Bc / 4), so a quarter-warp's eight groups
// read eight neighbouring rows (distinct banks, kPadBytes). A thread owns
// one item, 4 rows x 4 outputs (the gate product: one unit's four gates;
// the carry product: four units), over one k-slice: the 4-wide chunks of k
// taken every ks-th. The slices' partial sums meet in shared memory and
// slice 0 adds them in slice order, so the item's owner (slice 0) holds
// the full sums. Every output is summed in one fixed order and there are
// no float atomics: every run gives the same bits.
//
// The geometry (Hb, grid, threads, k-tile, pinned or streamed, shared
// bytes, rows per chunk) is decided in Python (lstm_kernel.lstm_geometry)
// and passed in as ints; threads = nrg * Hb * ks exactly, the same for
// every chunk (the last one padded). Pinned: the block's wh slice sits in
// shared memory for the whole launch. Streamed: it is copied in k-tiles
// beside each tile of rows. H is a multiple of 16 bytes of E (16-byte
// copies): of 4 for float, of 8 for bf16.

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace colsplit {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kStages = 4;  // tiles in the copy pipeline
// elements of E in one 16-byte copy; also the padding of a staged row
// (16 bytes: keeps rows 16-byte aligned and shifts each row's banks)
template <class E>
constexpr int kVec = 16 / (int)sizeof(E);

template <class E>
constexpr bool kF32 = std::is_same<E, float>::value;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// float32 -> E, rounding to nearest even for bf16
template <class E>
__device__ __forceinline__ E from_f32(float x) {
  if constexpr (kF32<E>)
    return x;
  else
    return __float2bfloat16_rn(x);
}

// four consecutive values as float32 (16 bytes of float, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// 16 bytes global -> shared through L2 only: for rows other blocks wrote
__device__ __forceinline__ void copy16_cg(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

// 4 bytes global -> shared (cp.async of 4 bytes may only go through L1):
// for read-only data (wh), and for dz columns the block itself wrote, in
// lines no block writes again in the launch (Walk::add_dwh)
__device__ __forceinline__ void copy4_ca(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copies_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N committed groups of copies are still in flight
template <int N>
__device__ __forceinline__ void copies_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// All blocks of the grid meet here. bar[0] counts arrivals, bar[1] is the
// generation; both start at 0 (the wrapper zeroes them per launch) and the
// count is back at 0 after every barrier. The fences order this block's
// global writes before its arrival and the other blocks' writes before
// its reads after the barrier.
__device__ __forceinline__ void grid_barrier(int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* gen = bar + 1;
    const int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1) == (int)gridDim.x - 1) {
      bar[0] = 0;  // no block arrives again before the generation moves
      __threadfence();
      *gen = g + 1;
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// This thread's item: row group rg, column group col (a unit, or a group
// of four units), k-slice; `items` items per slice, ks slices.
struct Item {
  int rg, col, slice, ks, items;
  __device__ __forceinline__ Item(int nrg, int cols) {
    items = nrg * cols;
    ks = blockDim.x / items;
    const int t = threadIdx.x;
    rg = t % nrg;
    col = (t / nrg) % cols;
    slice = t / items;  // >= ks: a spare thread, in no slice
  }
  __device__ __forceinline__ bool owner() const { return slice == 0; }
};

// Zero the first `bytes` (a multiple of 4) of the block's shared memory
// once: padding rows and units are read as zeros and never written.
__device__ __forceinline__ void zero_smem(float* smem, int bytes) {
  for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
}

// The slices' partial sums of acc (4 x 4 per item) added in slice order
// into slice 0's acc, through red (threads x 16 floats). Every thread adds
// up some of the 16 x items outputs, so the owners do not add alone.
__device__ __forceinline__ void reduce_slices(float (&acc)[4][4], float* red, const Item& it) {
  if (it.ks == 1) return;
  const int item = threadIdx.x % it.items, outputs = 16 * it.items;
  if (it.slice < it.ks) {
#pragma unroll
    for (int e = 0; e < 16; ++e) red[(it.slice * 16 + e) * it.items + item] = acc[e / 4][e % 4];
  }
  __syncthreads();
  // output o = e * items + item sums red[s * outputs + o] over s, into
  // slice 0's slot, which only this thread reads
  for (int o = threadIdx.x; o < outputs; o += blockDim.x) {
    float v = red[o];
    for (int s = 1; s < it.ks; ++s) v += red[s * outputs + o];
    red[o] = v;
  }
  __syncthreads();
  if (it.owner()) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e / 4][e % 4] = red[e * it.items + item];
  }
  __syncthreads();  // red is free again
}

// Tiles 0..n-1 through a kStages-buffer pipeline, starting at tile
// `first` and wrapping: issue(c, buf) starts tile c's copies into buffer
// buf, use(c, buf) reads them once they have landed. One commit group per
// tile (empty past the end): before tile i is used, i + kStages - 1 groups
// are committed, so waiting for all but the newest kStages - 2 means tile
// i has landed. The barrier after that wait also means every thread is
// done with tile i-1, whose buffer tile i + kStages - 1 then takes.
template <class Issue, class Use>
__device__ __forceinline__ void pipelined_tiles(int n, int first, Issue issue, Use use) {
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue((first + s) % n, s);
    copies_commit();
  }
  for (int i = 0; i < n; ++i) {
    copies_wait<kStages - 2>();
    __syncthreads();
    const int ahead = i + kStages - 1;
    if (ahead < n) issue((first + ahead) % n, ahead % kStages);
    copies_commit();
    use((first + i) % n, i % kStages);
  }
  __syncthreads();  // the buffers are free for the caller
}

// st[b][v] = x[b][c0 + v] for b < rows, v < cn (cn a multiple of kVec),
// rows ld elements apart, as 16-byte copies through L2
template <class E>
__device__ __forceinline__ void stage_rows(E* st, int ld, const E* x, int ldx, int rows, int c0,
                                           int cn) {
  constexpr int V = kVec<E>;
  const int q = cn / V;
  for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
    const int b = idx / q, v = V * (idx - b * q);
    copy16_cg(st + b * ld + v, x + (size_t)b * ldx + c0 + v);
  }
}

// wc[k][u][g] = wh[k0 + k, g*H + j0 + u] for k < kn, u < n_units: the
// block's gate columns of wh rows k0 .. k0+kn-1, the four gates of a unit
// side by side (one 4-wide load). Element idx of the tile is wc[dst] =
// wh[src] with (dst, src) from col_index.
__device__ __forceinline__ void col_index(int idx, int H, int j0, int n_units, int Hb, int k0,
                                          int& dst, size_t& src) {
  const int per_k = 4 * n_units;
  const int k = idx / per_k, r = idx - k * per_k;
  const int g = r / n_units, u = r - g * n_units;
  dst = k * 4 * Hb + u * 4 + g;
  src = (size_t)(k0 + k) * 4 * H + g * H + j0 + u;
}

// floats: one 4-byte cp.async each
__device__ __forceinline__ void load_cols(float* wc, const float* __restrict__ wh, int H, int j0,
                                          int n_units, int Hb, int k0, int kn) {
  for (int idx = threadIdx.x; idx < kn * 4 * n_units; idx += blockDim.x) {
    int dst;
    size_t src;
    col_index(idx, H, j0, n_units, Hb, k0, dst, src);
    copy4_ca(wc + dst, wh + src);
  }
}

// bf16: 2 bytes, below cp.async's least size, so the thread loads and
// stores them itself, kBatch loads in flight before the first store
__device__ __forceinline__ void load_cols(bf16* wc, const bf16* __restrict__ wh, int H, int j0,
                                          int n_units, int Hb, int k0, int kn) {
  constexpr int kBatch = 8;
  const int n = kn * 4 * n_units, step = blockDim.x;
  for (int base = threadIdx.x; base < n; base += kBatch * step) {
    bf16 v[kBatch];
    int dst[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * step;
      size_t src = 0;
      dst[i] = -1;
      if (idx < n) col_index(idx, H, j0, n_units, Hb, k0, dst[i], src);
      if (idx < n) v[i] = __ldg(wh + src);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (dst[i] >= 0) wc[dst[i]] = v[i];
  }
}

// acc[r][g] = sum_k h[rg + r*nrg, k] * wh[k, g*H + j0 + col], for the
// owner of item (rg, col); col runs over Hb units (past n_units: zero
// columns). h holds the chunk's `rows` real rows (of Bc); it is read in
// k-tiles of kt columns into the kStages staging buffers st (Bc rows of
// kt + kVec elements each); pinned: wc holds all H rows of the block's
// columns, streamed: kStages k-tile buffers of them, copied beside h's.
template <class E>
__device__ __forceinline__ void gate_product(float (&acc)[4][4], const E* h,
                                             const E* __restrict__ wh, E* wc, E* st, float* red,
                                             const Item& it, int rows, int Bc, int H, int Hb,
                                             int j0, int n_units, int kt, int pinned) {
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  const int ld = kt + kVec<E>, n = (H + kt - 1) / kt, nrg = Bc / 4;
  pipelined_tiles(
      n, blockIdx.x % n,
      [&](int c, int buf) {
        const int k0 = c * kt, kn = imin(kt, H - k0);
        stage_rows(st + buf * Bc * ld, ld, h, H, rows, k0, kn);
        if (!pinned) load_cols(wc + buf * kt * 4 * Hb, wh, H, j0, n_units, Hb, k0, kn);
      },
      [&](int c, int buf) {
        if (it.slice >= it.ks) return;
        const int k0 = c * kt, kn = imin(kt, H - k0);
        const E* s = st + buf * Bc * ld + it.rg * ld;
        const E* w = (pinned ? wc + (size_t)k0 * 4 * Hb : wc + buf * kt * 4 * Hb) + it.col * 4;
        for (int k = 4 * it.slice; k < kn; k += 4 * it.ks) {
          float4 hv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) hv[r] = load4(s + r * nrg * ld + k);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 wq = load4(w + (k + q) * 4 * Hb);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float x = q == 0 ? hv[r].x : q == 1 ? hv[r].y : q == 2 ? hv[r].z : hv[r].w;
              acc[r][0] = fmaf(x, wq.x, acc[r][0]);
              acc[r][1] = fmaf(x, wq.y, acc[r][1]);
              acc[r][2] = fmaf(x, wq.z, acc[r][2]);
              acc[r][3] = fmaf(x, wq.w, acc[r][3]);
            }
          }
        }
      });
  reduce_slices(acc, red, it);
}

// One block's part of the reverse walk, shared by the backward kernels.
// The block owns Hb units, their four gate columns of wh (for the gate
// recompute) and their Hb rows of wh (for the carry), both pinned in
// shared memory where they fit or streamed in k-tiles, and all B rows,
// in chunks of Bc. A step t is, chunk by chunk,
//   1. dz_step: recompute the block's Bc x 4Hb gates from h_{t-1}, form
//      dz[t] for its columns from its (dh, dc) carry and write it into
//      the exchange buffer x_t (E; for float the output dz itself) and,
//      where given, a float32 copy f_t;
//   2. the caller's grid barrier;
//   3. carry_product: read the whole chunk of x_t (Bc x 4H) through L2
//      and form dh for the block's units against its rows of wh;
//      store_carry keeps it for step t-1.
// The (dh, dc) carry of the block's units never leaves the block, so one
// barrier per step is enough, and the carry reads wh's rows directly (no
// wh^T copy). With kSeam, row b keeps step t's output cotangent only where
// t >= burn[b] and its carry into t-1 only where t > burn[b]; without,
// every step keeps both.
//
// Shared memory: the gate columns (pinned: H x 4Hb; streamed: kStages
// kt x 4Hb tiles); the rows, wr[u][m] = wh[j0 + u, m], Hbp rows of wr_ld
// elements (pinned: all 4H columns; streamed: kStages tiles of kt); the
// kStages Bc x (kt + kVec) staging tiles (of h or dz); with one chunk the
// dh carry dh_s[row][unit]; the slices' partials. With more chunks the dh
// and dc carries are this block's two (chunks*Bc) x Hb slabs of `carry`.
// kChunked says which at compile time: with one chunk the walk is the
// code it was before row chunks, with no chunk loop or carry reloads.
template <class E, bool kChunked>
struct Walk {
  const E* wh;
  const int* burn;  // (B,) seams, or null without kSeam
  int B, H, Hb, kt, pinned, Bc, chunks;
  int j0, n_units, nrg, Hbp, ld, wr_ld;
  int wc_elems, wr_elems, st_elems;
  E *wc, *wr, *st;
  float *dh_s, *dc_g, *red;  // dc_g: the dc carry, with more than one chunk
  Item it;  // the gate product's items: 4 rows x 1 unit
  Item ic;  // the carry product's: 4 rows x 4 units
  int j;    // the item's unit, clamped for padding units (never stored)
  bool unit_ok;
  int q;                // the chunk that row, seam and dc describe
  int row[4], seam[4];  // the item's rows, clamped for padding rows
  float dc[4];          // the item's dc carry

  __device__ __forceinline__ Walk(float* smem, const E* wh_, const float* dcT, const int* burn_,
                                  int B_, int H_, int Hb_, int kt_, int pinned_, int Bc_,
                                  float* carry)
      : wh(wh_), burn(burn_), B(B_), H(H_), Hb(Hb_), kt(kt_), pinned(pinned_), Bc(Bc_),
        chunks((B_ + Bc_ - 1) / Bc_), j0(blockIdx.x * Hb_),
        n_units(imin(Hb_, H_ - (int)blockIdx.x * Hb_)), nrg(Bc_ / 4), Hbp((Hb_ + 3) & ~3),
        ld(kt_ + kVec<E>), wr_ld((pinned_ ? 4 * H_ : kt_) + kVec<E>), it(Bc_ / 4, Hb_),
        ic(Bc_ / 4, ((Hb_ + 3) & ~3) / 4) {
    const int H4 = 4 * H;
    wc_elems = (pinned ? H : kStages * kt) * 4 * Hb;
    wr_elems = (pinned ? 1 : kStages) * Hbp * wr_ld;
    st_elems = kStages * Bc * ld;
    wc = reinterpret_cast<E*>(smem);
    wr = wc + wc_elems;
    st = wr + wr_elems;
    float* tail = reinterpret_cast<float*>(st + st_elems);
    const int tiles_bytes = (wc_elems + wr_elems + st_elems) * (int)sizeof(E);
    if constexpr (!kChunked) {
      dh_s = tail;  // 0 at first: the h_T cotangent is folded into dout[T-1]
      dc_g = nullptr;
      red = dh_s + Bc * Hb;
      zero_smem(smem, tiles_bytes + Bc * Hb * 4);
    } else {
      const int slab = chunks * Bc * Hb;
      dh_s = carry + (size_t)blockIdx.x * slab;
      dc_g = carry + (size_t)(gridDim.x + blockIdx.x) * slab;
      red = tail;
      for (int i = threadIdx.x; i < slab; i += blockDim.x) dh_s[i] = 0.0f;
      zero_smem(smem, tiles_bytes);
    }
    j = j0 + imin(it.col, n_units - 1);
    unit_ok = it.col < n_units;
    for (int c = n_chunks() - 1; c >= 0; --c) {  // ends on chunk 0
      set_chunk(c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dc[r] = __ldg(dcT + (size_t)row[r] * H + j);
        if (kChunked && it.owner()) dc_g[slot(r)] = dc[r];
      }
    }
    if (pinned) {  // lands with the first tile
      load_cols(wc, wh, H, j0, n_units, Hb, 0, H);
      stage_rows(wr, wr_ld, wh + (size_t)j0 * H4, H4, n_units, 0, H4);
    }
  }

  // the chunks of the batch: a constant 1 unless kChunked
  __device__ __forceinline__ int n_chunks() const { return kChunked ? chunks : 1; }
  // the first row of chunk c (0 unless kChunked)
  __device__ __forceinline__ int first(int c) const { return kChunked ? c * Bc : 0; }

  // the item's rows (and their seams) in chunk c
  __device__ __forceinline__ void set_chunk(int c) {
    q = c;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      row[r] = imin(first(c) + it.rg + r * nrg, B - 1);
      seam[r] = burn ? __ldg(burn + row[r]) : 0;
    }
  }
  // whether the item's row r of the current chunk is a real row
  __device__ __forceinline__ bool real(int r) const { return first(q) + it.rg + r * nrg < B; }
  // the item's row r of the current chunk in the block's carry slabs
  __device__ __forceinline__ int slot(int r) const {
    return (first(q) + it.rg + r * nrg) * Hb + it.col;
  }

  // Step t's dz columns of this block for chunk c, from h_{t-1} (hprev),
  // c_{t-1} (cprev) and c_t (ct), each (B, H), dout (B, H) and proj
  // (B, 4H), written into x_t (B, 4H) and, where given, f_t; the dc carry
  // moves on to step t-1.
  template <bool kSeam>
  __device__ __forceinline__ void dz_step(int t, int c, const float* dout, const E* proj,
                                          const E* hprev, const float* cprev, const float* ct,
                                          E* x_t, float* f_t) {
    if constexpr (kChunked) {
      set_chunk(c);
      if (it.owner()) {
#pragma unroll
        for (int r = 0; r < 4; ++r) dc[r] = dc_g[slot(r)];
      }
    }
    // the step's inputs (owners of real rows only), loaded before the
    // product hides them; c through L2 (K5 wrote it in this launch)
    float z[4][4], d_out[4], c_t[4], c_prev[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const size_t o = (size_t)row[r] * H + j;
      const bool load = it.owner() && real(r);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        z[r][g] = load ? to_f32(__ldg(proj + 4 * (o - j) + g * H + j)) : 0.0f;
      d_out[r] = load && (!kSeam || t >= seam[r]) ? __ldg(dout + o) : 0.0f;
      c_t[r] = load ? __ldcg(ct + o) : 0.0f;
      c_prev[r] = load ? __ldcg(cprev + o) : 0.0f;
    }
    float acc[4][4];
    gate_product(acc, hprev + (size_t)first(q) * H, wh, wc, st, red, it, imin(Bc, B - first(q)),
                 Bc, H, Hb, j0, n_units, kt, pinned);
    if (!it.owner()) return;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float ig = sigmoid_f32(z[r][0] + acc[r][0]);
      const float fg = sigmoid_f32(z[r][1] + acc[r][1]);
      const float gg = tanhf(z[r][2] + acc[r][2]);
      const float og = sigmoid_f32(z[r][3] + acc[r][3]);
      const float tc = tanhf(c_t[r]);
      const float dht = d_out[r] + dh_s[(first(q) + it.rg + r * nrg) * Hb + it.col];
      const float d_o = dht * tc;
      const float dct = dht * og * (1.0f - tc * tc) + dc[r];
      const float di = dct * gg;
      const float df = dct * c_prev[r];
      const float dg = dct * ig;
      dc[r] = (!kSeam || t > seam[r]) ? dct * fg : 0.0f;
      if (!unit_ok || !real(r)) continue;
      const float v[4] = {di * ig * (1.0f - ig), df * fg * (1.0f - fg), dg * (1.0f - gg * gg),
                          d_o * og * (1.0f - og)};
      const size_t o = (size_t)row[r] * 4 * H + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) x_t[o + g * H] = from_f32<E>(v[g]);
      if constexpr (!kF32<E>) {
        if (f_t) {
#pragma unroll
          for (int g = 0; g < 4; ++g) f_t[o + g * H] = v[g];
        }
      }
    }
    if constexpr (kChunked) {
#pragma unroll
      for (int r = 0; r < 4; ++r) dc_g[slot(r)] = dc[r];
    }
  }

  // a[r][u] = sum_m x_t[c*Bc + rg + r*nrg, m] * wh[j0 + 4col + u, m] for
  // the owner of carry item (rg, col), over the 4H columns m in tiles;
  // x_t complete (after the grid barrier)
  __device__ __forceinline__ void carry_product(float (&a)[4][4], const E* x_t, int c) {
    const int H4 = 4 * H;
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r][0] = a[r][1] = a[r][2] = a[r][3] = 0.0f;
    const int n = (H4 + kt - 1) / kt, rows = imin(Bc, B - first(c));
    const E* x = x_t + (size_t)first(c) * H4;
    pipelined_tiles(
        n, blockIdx.x % n,
        [&](int tile, int buf) {
          const int m0 = tile * kt, mn = imin(kt, H4 - m0);
          stage_rows(st + buf * Bc * ld, ld, x, H4, rows, m0, mn);
          if (!pinned)
            stage_rows(wr + buf * Hbp * wr_ld, wr_ld, wh + (size_t)j0 * H4, H4, n_units, m0, mn);
        },
        [&](int tile, int buf) {
          if (ic.slice >= ic.ks) return;
          const int m0 = tile * kt, mn = imin(kt, H4 - m0);
          const E* s = st + buf * Bc * ld + ic.rg * ld;
          const E* w = (pinned ? wr + m0 : wr + buf * Hbp * wr_ld) + 4 * ic.col * wr_ld;
          for (int m = 4 * ic.slice; m < mn; m += 4 * ic.ks) {
            float4 d[4], w4[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) d[r] = load4(s + r * nrg * ld + m);
#pragma unroll
            for (int u = 0; u < 4; ++u) w4[u] = load4(w + u * wr_ld + m);
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
  }

  // the carry product's dh of chunk c, kept for step t-1 (masked with kSeam)
  template <bool kSeam>
  __device__ __forceinline__ void store_carry(const float (&a)[4][4], int t, int c) {
    if (!ic.owner()) return;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = first(c) + ic.rg + r * nrg;
      const bool keep = rr < B && (!kSeam || t > __ldg(burn + imin(rr, B - 1)));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int uu = 4 * ic.col + u;
        if (uu < Hb) dh_s[rr * Hb + uu] = keep ? a[r][u] : 0.0f;
      }
    }
  }

  // the carry product's dh of chunk c's real rows and units into x (B, H)
  __device__ __forceinline__ void store_dh(const float (&a)[4][4], float* x, int c) const {
    if (!ic.owner()) return;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = first(c) + ic.rg + r * nrg;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int uu = 4 * ic.col + u;
        if (rr < B && uu < n_units) x[(size_t)rr * H + j0 + uu] = a[r][u];
      }
    }
  }

  // the dc carry of the real rows and units into x (B, H)
  __device__ __forceinline__ void store_dc(float* x) {
    if (!it.owner() || !unit_ok) return;
    for (int c = 0; c < n_chunks(); ++c) {
      if constexpr (kChunked) {
        set_chunk(c);
#pragma unroll
        for (int r = 0; r < 4; ++r) dc[r] = dc_g[slot(r)];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (real(r)) x[(size_t)row[r] * H + j] = dc[r];
    }
  }

  // The block's columns of dWh: dwh[k, g*H + j0 + u] for every k < H and
  // the block's units u, set (or, with accumulate, added to) the sum over
  // m = s*B + b, in that order, of h_s[b, k] * dz[m, g*H + j0 + u], where
  // hrows(s) is the (B, H) h entering step s (E) and dz the steps' (B, 4H)
  // float32 rows, `steps` of them. The columns belong to this block alone:
  // no partials, no atomics, one summation order. Thread (kg, ug) owns
  // rows k0 + 4kg .. +3 of a kc-row chunk and unit ug's four gates; the
  // rows of h and dz are staged in tiles of mt through the copy pipeline,
  // in the staging tiles (pinned) or in all the walk's tile buffers
  // (streamed). lstm_geometry makes sure a tile holds a row. The caller
  // orders dz's writes before this (a barrier); the steps' dz rows are
  // written no more before this pass is done.
  template <class HRows>
  __device__ __forceinline__ void add_dwh(float* dwh, HRows hrows, const float* dz, int steps,
                                          bool accumulate) {
    constexpr int V = kVec<E>;
    const int H4 = 4 * H;
    const int ug = threadIdx.x % Hb, kg = threadIdx.x / Hb;
    const int kc = imin(H, 4 * ((int)blockDim.x / Hb) / V * V);
    const int h_ld = kc + V, d_ld = 4 * Hb + 4;
    char* tiles = reinterpret_cast<char*>(pinned ? st : wc);
    const int region = (pinned ? st_elems : wc_elems + wr_elems + st_elems) * (int)sizeof(E);
    const int stage = (region / kStages) & ~15;
    const int mt = stage / (h_ld * (int)sizeof(E) + d_ld * 4);
    const int M = steps * B, n = (M + mt - 1) / mt;
    for (int k0 = 0; k0 < H; k0 += kc) {
      const int kn = imin(kc, H - k0);
      const bool mine = 4 * kg < kn && ug < n_units;
      float* out = dwh + (size_t)(k0 + 4 * kg) * H4 + j0 + ug;
      float acc[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[kk][g] = mine && accumulate ? out[kk * H4 + g * H] : 0.0f;
      }
      pipelined_tiles(
          n, 0,
          [&](int c, int buf) {
            const int m0 = c * mt, mn = imin(mt, M - m0);
            E* hs = reinterpret_cast<E*>(tiles + buf * stage);
            float* ds = reinterpret_cast<float*>(hs + mt * h_ld);
            const int q = kn / V;
            for (int idx = threadIdx.x; idx < mn * q; idx += blockDim.x) {
              const int m = idx / q, v = V * (idx - m * q);
              const int s = (m0 + m) / B, b = m0 + m - s * B;
              copy16_cg(hs + m * h_ld + v, hrows(s) + (size_t)b * H + k0 + v);
            }
            // the block's dz columns, unit-major: ds[m][4u + g]
            const int per = 4 * n_units;
            for (int idx = threadIdx.x; idx < mn * per; idx += blockDim.x) {
              const int m = idx / per, r = idx - m * per;
              const int g = r / n_units, u = r - g * n_units;
              copy4_ca(ds + m * d_ld + 4 * u + g, dz + (size_t)(m0 + m) * H4 + g * H + j0 + u);
            }
          },
          [&](int c, int buf) {
            if (!mine) return;
            const int mn = imin(mt, M - c * mt);
            const E* hs = reinterpret_cast<const E*>(tiles + buf * stage);
            const float* ds = reinterpret_cast<const float*>(hs + mt * h_ld) + 4 * ug;
            hs += 4 * kg;
            for (int m = 0; m < mn; ++m) {
              const float4 h4 = load4(hs + m * h_ld);
              const float4 d4 = load4(ds + m * d_ld);
              const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                acc[kk][0] = fmaf(hv[kk], d4.x, acc[kk][0]);
                acc[kk][1] = fmaf(hv[kk], d4.y, acc[kk][1]);
                acc[kk][2] = fmaf(hv[kk], d4.z, acc[kk][2]);
                acc[kk][3] = fmaf(hv[kk], d4.w, acc[kk][3]);
              }
            }
          });
      if (mine) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int g = 0; g < 4; ++g) out[kk * H4 + g * H] = acc[kk][g];
        }
      }
    }
  }
};

// A cooperative launch: every block resident at once, or no launch. The
// grid is checked against the card's occupancy for this kernel first.
template <class... Exp, class... Act>
cudaError_t launch_cooperative(void (*kernel)(Exp...), int grid, int threads, int smem,
                               void* stream, Act... args) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
  if (e != cudaSuccess) return e;
  if (grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace colsplit
