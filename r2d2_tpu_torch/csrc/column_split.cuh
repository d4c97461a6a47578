// Shared pieces of the column-split LSTM kernels (lstm_fwd.cu and
// lstm_seq_bwd.cu), float32, for Hopper (sm_90a).
//
// The layout. A persistent cooperative grid of about one block per SM.
// Block x owns the hidden units j0 = x*Hb .. j0+n_units-1 and their four
// gate columns (j, H+j, 2H+j, 3H+j) of wh, for all B batch rows. Each step
// ends in one grid barrier, after which every block reads the whole step's
// exchanged rows (h_t in the forward, dz_t in the backward) from global
// memory through L2 only (cp.async.cg: never the non-coherent read-only
// path nor L1, since other blocks wrote them in this launch).
//
// The exchanged rows are read in column tiles through a kStages-buffer
// cp.async pipeline, so several tiles' copies fly while one is multiplied;
// each block starts at its own tile (blockIdx modulo the tile count), so
// the SMs do not all ask the same L2 lines at once.
//
// The products are register-tiled, since shared memory, not the FMA
// units, bounds a thread that loads two values per four FMAs. The rows
// are padded to Bp = 4 * nrg and dealt in row groups: group rg holds rows
// rg, rg + nrg, rg + 2nrg, rg + 3nrg, so a quarter-warp's eight groups
// read eight neighbouring rows (distinct banks, kPad). A thread owns one
// item, 4 rows x 4 outputs (the gate product: one unit's four gates; the
// carry product: four units), over one k-slice: the 4-wide chunks of k
// taken every ks-th. The slices' partial sums meet in shared memory and
// slice 0 adds them in slice order, so the item's owner (slice 0) holds
// the full sums. Every output is summed in one fixed order and there are
// no float atomics: every run gives the same bits.
//
// The geometry (Hb, grid, threads, k-tile, pinned or streamed, shared
// bytes) is decided in Python (lstm_kernel.lstm_geometry) and passed in as
// ints; threads = nrg * Hb * ks exactly. Pinned: the block's wh slice sits
// in shared memory for the whole launch. Streamed: it is copied in k-tiles
// beside each tile of rows. H is a multiple of 4 (16-byte copies).

#pragma once
#include <cuda_runtime.h>

namespace colsplit {

constexpr int kMaxThreads = 512;
constexpr int kPad = 4;     // floats of padding per staged row (keeps 16-byte rows)
constexpr int kStages = 4;  // tiles in the copy pipeline

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// 16 bytes global -> shared through L2 only: for rows other blocks wrote
__device__ __forceinline__ void copy16_cg(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

// 4 bytes global -> shared, for read-only data (wh)
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

// Zero the block's shared memory once: padding rows and units are read as
// zeros and never written.
__device__ __forceinline__ void zero_smem(float* smem, int floats) {
  for (int i = threadIdx.x; i < floats; i += blockDim.x) smem[i] = 0.0f;
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

// st[b][v] = x[b][c0 + v] for b < rows, v < cn (cn a multiple of 4), rows
// ld floats apart, as 16-byte copies through L2
__device__ __forceinline__ void stage_rows(float* st, int ld, const float* x, int ldx,
                                           int rows, int c0, int cn) {
  const int q = cn >> 2;
  for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
    const int b = idx / q, v = 4 * (idx - b * q);
    copy16_cg(st + b * ld + v, x + (size_t)b * ldx + c0 + v);
  }
}

// wc[k][u][g] = wh[k0 + k, g*H + j0 + u] for k < kn, u < n_units: the
// block's gate columns of wh rows k0 .. k0+kn-1, the four gates of a unit
// side by side (one float4 load)
__device__ __forceinline__ void load_cols(float* wc, const float* __restrict__ wh, int H,
                                          int j0, int n_units, int Hb, int k0, int kn) {
  const int per_k = 4 * n_units;
  for (int idx = threadIdx.x; idx < kn * per_k; idx += blockDim.x) {
    const int k = idx / per_k, r = idx - k * per_k;
    const int g = r / n_units, u = r - g * n_units;
    copy4_ca(wc + k * 4 * Hb + u * 4 + g, wh + (size_t)(k0 + k) * 4 * H + g * H + j0 + u);
  }
}

// acc[r][g] = sum_k h[rg + r*nrg, k] * wh[k, g*H + j0 + col], for the
// owner of item (rg, col); col runs over Hb units (past n_units: zero
// columns). h (B, H) is read in k-tiles of kt columns into the kStages
// staging buffers st (Bp rows of kt + kPad floats each); pinned: wc holds
// all H rows of the block's columns, streamed: kStages k-tile buffers of
// them, copied beside h's.
__device__ __forceinline__ void gate_product(float (&acc)[4][4], const float* h,
                                             const float* __restrict__ wh, float* wc,
                                             float* st, float* red, const Item& it, int B,
                                             int Bp, int H, int Hb, int j0, int n_units, int kt,
                                             int pinned) {
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  const int ld = kt + kPad, n = (H + kt - 1) / kt, nrg = Bp / 4;
  pipelined_tiles(
      n, blockIdx.x % n,
      [&](int c, int buf) {
        const int k0 = c * kt, kn = imin(kt, H - k0);
        stage_rows(st + buf * Bp * ld, ld, h, H, B, k0, kn);
        if (!pinned) load_cols(wc + buf * kt * 4 * Hb, wh, H, j0, n_units, Hb, k0, kn);
      },
      [&](int c, int buf) {
        if (it.slice >= it.ks) return;
        const int k0 = c * kt, kn = imin(kt, H - k0);
        const float* s = st + buf * Bp * ld + it.rg * ld;
        const float* w = (pinned ? wc + (size_t)k0 * 4 * Hb : wc + buf * kt * 4 * Hb) + it.col * 4;
        for (int k = 4 * it.slice; k < kn; k += 4 * it.ks) {
          float4 hv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) hv[r] = *reinterpret_cast<const float4*>(s + r * nrg * ld + k);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 wq = *reinterpret_cast<const float4*>(w + (k + q) * 4 * Hb);
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
