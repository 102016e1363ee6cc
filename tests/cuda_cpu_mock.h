// A CPU stand-in for the CUDA runtime, enough to run the engine kernels'
// logic with g++ (tests/test_torch_engine_run_cpu.py): every CUDA thread
// of a block is a std::thread, __syncthreads is a std::barrier over the
// block, the warp votes and reductions exchange values through a
// std::barrier over each warp of 32 threads, atomics are std::atomic_ref.
// Blocks of a grid run one after another.  It checks what the kernels
// compute and in which order, not how fast, and nothing about the GPU's
// compiler.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
// a block's shared variables are one instance for all its threads
#define __shared__ static
#define __launch_bounds__(x)
#define __align__(x) alignas(x)

using std::max;
using std::min;

struct mock_dim3 {
  unsigned x, y, z;
};
inline thread_local mock_dim3 threadIdx;
inline thread_local mock_dim3 blockIdx;
inline mock_dim3 blockDim;
inline mock_dim3 gridDim;

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

struct MockWarp {
  std::barrier<> bar;
  uint64_t slot[32];
  explicit MockWarp(int lanes) : bar(lanes) {}
};
inline std::unique_ptr<std::barrier<>> mock_block_barrier;
inline std::vector<std::unique_ptr<MockWarp>> mock_warps;
inline std::vector<unsigned char> mock_dynamic_smem;
inline unsigned char* mock_smem() { return mock_dynamic_smem.data(); }

inline void __syncthreads() { mock_block_barrier->arrive_and_wait(); }

// every lane's v, once all 32 lanes of the warp have given theirs
inline void mock_warp_exchange(uint64_t v, uint64_t out[32]) {
  MockWarp& w = *mock_warps[threadIdx.x / 32];
  w.slot[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 32; ++i) out[i] = w.slot[i];
  w.bar.arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned, int pred) {
  uint64_t o[32];
  mock_warp_exchange(pred != 0, o);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= o[i] ? 1u << i : 0u;
  return r;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  uint64_t o[32];
  mock_warp_exchange(v, o);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r += static_cast<unsigned>(o[i]);
  return r;
}
inline int __reduce_add_sync(unsigned m, int v) {
  return static_cast<int>(__reduce_add_sync(m, static_cast<unsigned>(v)));
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  uint64_t o[32];
  mock_warp_exchange(v, o);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r = std::max(r, static_cast<unsigned>(o[i]));
  return r;
}
inline long long __shfl_down_sync(unsigned, long long v, int off) {
  uint64_t o[32];
  mock_warp_exchange(static_cast<uint64_t>(v), o);
  const int l = threadIdx.x % 32;
  return l + off < 32 ? static_cast<long long>(o[l + off]) : v;
}
template <class T>
T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> r(*p);
  int cur = r.load();
  while (cur < v && !r.compare_exchange_weak(cur, v)) {
  }
  return cur;
}
inline unsigned long long atomicMin(unsigned long long* p,
                                    unsigned long long v) {
  std::atomic_ref<unsigned long long> r(*p);
  unsigned long long cur = r.load();
  while (v < cur && !r.compare_exchange_weak(cur, v)) {
  }
  return cur;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
// compiled with -ffp-contract=off: each op rounds on its own
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

// kernel<<<grid, block, smem, stream>>>(args...), rewritten by the test
template <class K, class... A>
void mock_launch(long long grid, int block, size_t smem, cudaStream_t,
                 K kern, A... args) {
  blockDim = {static_cast<unsigned>(block), 1, 1};
  gridDim = {static_cast<unsigned>(grid), 1, 1};
  for (long long b = 0; b < grid; ++b) {
    mock_block_barrier = std::make_unique<std::barrier<>>(block);
    mock_warps.clear();
    for (int w = 0; w < (block + 31) / 32; ++w)
      mock_warps.push_back(
          std::make_unique<MockWarp>(std::min(32, block - 32 * w)));
    mock_dynamic_smem.assign(smem + 16, 0xAB);  // garbage, as on a GPU
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        blockIdx = {static_cast<unsigned>(b), 0, 0};
        kern(args...);
      });
    for (auto& th : threads) th.join();
  }
}
