// CPU emulation of the CUDA subset that r2d2_tpu_torch/csrc uses, so the
// kernels' indexing, masks and barriers can be checked with g++ on a
// machine without a card (tests/test_torch_kernel_emulation.py). One
// std::thread per CUDA thread, a std::barrier for __syncthreads, blocks run
// one after another, shared memory poisoned so a read before a write shows.
// It says nothing about warps, the memory model or speed.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
struct uint3_ { unsigned x = 0, y = 0, z = 0; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local uint3_ threadIdx;
inline uint3_ blockIdx;
inline dim3 blockDim;
inline std::barrier<>* g_bar = nullptr;
inline float* g_smem = nullptr;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
typedef int cudaError_t; enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class F> void emulate(dim3 grid, int threads, size_t smem_bytes, cudaStream_t, F fn) {
  std::vector<float> sm(smem_bytes / 4 + 1, -1e30f);  // poison: reads before writes show
  g_smem = sm.data();
  blockDim = dim3(threads);
  for (unsigned b = 0; b < grid.x; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(threads);
    g_bar = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) ts.emplace_back([&, t] { threadIdx.x = t; fn(); });
    for (auto& x : ts) x.join();
  }
}
