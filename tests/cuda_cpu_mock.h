// A CPU stand-in for the CUDA runtime, enough to run the port's kernels'
// logic with g++ (tests/engine_mock.py, the colibri_scatter and recurrence
// kernel tests).  It checks what the kernels compute and in which order,
// not how fast, and nothing about the GPU's compiler.
//
// Every CUDA thread of a block is a fiber on ONE OS thread, with its own
// stack.  __syncthreads and the warp votes, reductions and shuffles are
// switches to a scheduler that resumes the fibers in thread order: a fiber
// waits at a barrier until every live thread of the block (of its warp,
// for a warp exchange) has arrived, and a thread that returns counts as
// arrived, as on the card.  The order is fixed, so a run is deterministic
// and its cost does not depend on how busy the machine is.  When no fiber
// can go on (a barrier that not all threads reach) the scheduler reports
// the deadlock on stderr and aborts.  mock_yield() lets a spinning thread
// give the others their turn.
//
// A block's shared variables are one instance for all its threads,
// atomics are std::atomic_ref, and the blocks of a grid run one after
// another, in index order or reversed (mock_set_block_order), or in any
// order a caller passes to mock_run_block.
#pragma once
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

#include <sys/mman.h>
#include <unistd.h>

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
inline mock_dim3 threadIdx;  // the running fiber's
inline mock_dim3 blockIdx;
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

inline std::vector<unsigned char> mock_dynamic_smem;
inline unsigned char* mock_smem() { return mock_dynamic_smem.data(); }

// ---- the switch: save the callee-saved registers on this stack, store
// its pointer in *save, continue on the stack `to` (x86-64 System V) -----
#if !defined(__x86_64__)
#error "the mock's fiber switch is written for x86-64"
#endif
extern "C" void mock_fiber_switch(void** save, void* to);
asm(R"(
  .text
  .p2align 4
  .globl mock_fiber_switch
  .type mock_fiber_switch, @function
mock_fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size mock_fiber_switch, .-mock_fiber_switch
)");

constexpr size_t kMockStack = 256 * 1024;  // bytes a fiber, one guard page
enum { kMockRun = 0, kMockAtBar = 1, kMockAtWarp = 2 };

struct MockFiber {
  unsigned char* mem = nullptr;  // the mapping: guard page, then the stack
  void* sp = nullptr;            // saved stack pointer while switched out
  int wait = kMockRun;
  unsigned gen = 0;  // the barrier generation it waits to see pass
  bool done = false;
};
struct MockWarp {
  int live = 0, arrived = 0;
  unsigned gen = 0;
  uint64_t slot[32] = {}, out[32] = {};
};

inline std::vector<std::unique_ptr<MockFiber>> mock_fiber;
inline std::vector<MockWarp> mock_warp;
inline void* mock_sched_sp;
inline int mock_cur = 0, mock_live = 0, mock_bar_arrived = 0;
inline unsigned mock_bar_gen = 0;
inline const std::function<void()>* mock_body = nullptr;
// called before each block runs (a stand-in's per-block state)
inline void (*mock_on_block)() = nullptr;

// back to the scheduler; returns when it resumes this fiber
inline void mock_to_scheduler() {
  mock_fiber_switch(&mock_fiber[mock_cur]->sp, mock_sched_sp);
}

// a thread that returned no longer holds back a barrier it never reaches
inline void mock_release_waits() {
  if (mock_bar_arrived > 0 && mock_bar_arrived == mock_live) {
    mock_bar_arrived = 0;
    ++mock_bar_gen;
  }
  for (MockWarp& w : mock_warp) {
    if (w.arrived > 0 && w.arrived == w.live) {
      std::memcpy(w.out, w.slot, sizeof w.out);
      w.arrived = 0;
      ++w.gen;
    }
  }
}

extern "C" inline void mock_fiber_entry() {
  (*mock_body)();
  MockFiber& f = *mock_fiber[mock_cur];
  f.done = true;
  --mock_live;
  --mock_warp[mock_cur / 32].live;
  mock_release_waits();
  mock_to_scheduler();  // never resumed
  std::abort();
}

inline void __syncthreads() {
  if (++mock_bar_arrived == mock_live) {
    mock_bar_arrived = 0;
    ++mock_bar_gen;
    return;
  }
  MockFiber& f = *mock_fiber[mock_cur];
  f.wait = kMockAtBar;
  f.gen = mock_bar_gen;
  mock_to_scheduler();
}

// every lane's v, once all live lanes of the warp have given theirs
inline void mock_warp_exchange(uint64_t v, uint64_t out[32]) {
  MockWarp& w = mock_warp[mock_cur / 32];
  w.slot[mock_cur % 32] = v;
  if (++w.arrived == w.live) {
    std::memcpy(w.out, w.slot, sizeof w.out);
    w.arrived = 0;
    ++w.gen;
  } else {
    MockFiber& f = *mock_fiber[mock_cur];
    f.wait = kMockAtWarp;
    f.gen = w.gen;
    mock_to_scheduler();
  }
  std::memcpy(out, w.out, sizeof w.out);
}

// let the other threads of the block run (a spin loop's pause)
inline void mock_yield() { mock_to_scheduler(); }

// Run block b of `block` threads, each calling body(), to completion.
inline void mock_run_block(long long b, int block, size_t smem,
                           const std::function<void()>& body) {
  blockIdx = {static_cast<unsigned>(b), 0, 0};
  mock_dynamic_smem.assign(smem + 16, 0xAB);  // garbage, as on a GPU
  const size_t page = static_cast<size_t>(sysconf(_SC_PAGESIZE));
  while (mock_fiber.size() < static_cast<size_t>(block)) {
    auto f = std::make_unique<MockFiber>();
    void* m = mmap(nullptr, kMockStack + page, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (m == MAP_FAILED) {
      std::fprintf(stderr, "mock: cannot map a fiber stack\n");
      std::abort();
    }
    mprotect(m, page, PROT_NONE);  // an overflow faults, not corrupts
    f->mem = static_cast<unsigned char*>(m);
    mock_fiber.push_back(std::move(f));
  }
  mock_warp.assign((block + 31) / 32, MockWarp{});
  for (int w = 0; w < (block + 31) / 32; ++w)
    mock_warp[w].live = std::min(32, block - 32 * w);
  mock_live = block;
  mock_bar_arrived = 0;
  mock_body = &body;
  if (mock_on_block) mock_on_block();
  for (int t = 0; t < block; ++t) {
    MockFiber& f = *mock_fiber[t];
    f.wait = kMockRun;
    f.done = false;
    // a frame mock_fiber_switch returns from into mock_fiber_entry, with
    // the stack aligned as at a call: [ret 0][entry][6 saved registers]
    void** sp = reinterpret_cast<void**>(
        reinterpret_cast<uintptr_t>(f.mem + page + kMockStack) &
        ~uintptr_t{15});
    *--sp = nullptr;
    *--sp = reinterpret_cast<void*>(&mock_fiber_entry);
    for (int r = 0; r < 6; ++r) *--sp = nullptr;
    f.sp = sp;
  }
  for (;;) {
    bool ran = false;
    for (int t = 0; t < block; ++t) {
      MockFiber& f = *mock_fiber[t];
      if (f.done) continue;
      if (f.wait == kMockAtBar && f.gen == mock_bar_gen) continue;
      if (f.wait == kMockAtWarp && f.gen == mock_warp[t / 32].gen) continue;
      f.wait = kMockRun;
      mock_cur = t;
      threadIdx = {static_cast<unsigned>(t), 0, 0};
      mock_fiber_switch(&mock_sched_sp, f.sp);
      ran = true;
    }
    if (mock_live == 0) break;
    if (!ran) {
      int at_bar = 0, at_warp = 0;
      for (int t = 0; t < block; ++t) {
        const MockFiber& f = *mock_fiber[t];
        at_bar += !f.done && f.wait == kMockAtBar;
        at_warp += !f.done && f.wait == kMockAtWarp;
      }
      std::fprintf(stderr,
                   "mock: deadlock in block %lld: %d of %d threads live, %d "
                   "at __syncthreads, %d at a warp exchange\n",
                   b, mock_live, block, at_bar, at_warp);
      std::abort();
    }
  }
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
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  uint64_t o[32];
  mock_warp_exchange(v, o);
  unsigned r = ~0u;
  for (int i = 0; i < 32; ++i) r = std::min(r, static_cast<unsigned>(o[i]));
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
inline int atomicMin(int* p, int v) {
  std::atomic_ref<int> r(*p);
  int cur = r.load();
  while (v < cur && !r.compare_exchange_weak(cur, v)) {
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
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
template <class V>
inline V __ldg(const V* p) { return *p; }

// the order the blocks of a grid run in: 0 in index order, 1 reversed
inline int mock_block_order = 0;
extern "C" void mock_set_block_order(int order) { mock_block_order = order; }

// kernel<<<grid, block, smem, stream>>>(args...), rewritten by the test
template <class K, class... A>
void mock_launch(long long grid, int block, size_t smem, cudaStream_t,
                 K kern, A... args) {
  blockDim = {static_cast<unsigned>(block), 1, 1};
  gridDim = {static_cast<unsigned>(grid), 1, 1};
  const std::function<void()> body = [&] { kern(args...); };
  for (long long j = 0; j < grid; ++j) {
    mock_run_block(mock_block_order == 1 ? grid - 1 - j : j, block, smem,
                   body);
  }
}
