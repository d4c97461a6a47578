// CPU emulation of the CUDA subset that r2d2_tpu_torch/csrc uses, so the
// kernels' indexing, masks and barriers can be checked with g++ on a
// machine without a card (tests/test_torch_kernel_emulation.py). One
// std::thread per CUDA thread, a std::barrier per block for
// __syncthreads and one per warp (32 threads, the last one ragged) for
// __syncwarp, shared memory poisoned so a read before a write shows.
// A cooperative cudaLaunchKernelEx runs all its blocks at once, so a grid
// barrier built on atomics meets. It says nothing about warps' lockstep,
// the memory model or speed.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
struct uint3_ { unsigned x = 0, y = 0, z = 0; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline thread_local uint3_ threadIdx;
inline thread_local uint3_ blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local std::barrier<>* g_bar = nullptr;
inline thread_local std::barrier<>* g_warp_bar = nullptr;
inline thread_local float* g_smem = nullptr;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp_bar->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorCooperativeLaunchTooLarge = 82,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16,
       cudaLaunchAttributeCooperative = 2 };
typedef void* cudaStream_t;
struct cudaLaunchAttribute { int id; struct { int cooperative; } val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream;
  cudaLaunchAttribute* attrs; unsigned numAttrs;
};
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1 << 16; return 0; }
template <class F> inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// n blocks at once, each with its own barrier and shared memory
template <class F> void run_blocks(unsigned n, int threads, size_t smem_bytes, F fn) {
  std::vector<std::vector<float>> sm(n, std::vector<float>(smem_bytes / 4 + 1, -1e30f));  // poison
  std::deque<std::barrier<>> bars, warp_bars;  // not movable: a deque never moves them
  const int warps = (threads + 31) / 32;
  for (unsigned i = 0; i < n; ++i) {
    bars.emplace_back(threads);
    for (int w = 0; w < warps; ++w) warp_bars.emplace_back(std::min(32, threads - 32 * w));
  }
  std::vector<std::thread> ts;
  for (unsigned i = 0; i < n; ++i)
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, i, t] {
        blockIdx.x = i; threadIdx.x = t; g_bar = &bars[i]; g_smem = sm[i].data();
        g_warp_bar = &warp_bars[i * warps + t / 32]; fn();
      });
  for (auto& x : ts) x.join();
}

template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...), Act&&... args) {
  blockDim = cfg->blockDim;
  gridDim = cfg->gridDim;
  run_blocks(cfg->gridDim.x, (int)cfg->blockDim.x, cfg->dynamicSmemBytes, [&] { kernel(args...); });
  return 0;
}
