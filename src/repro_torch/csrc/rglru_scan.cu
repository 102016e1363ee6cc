// rglru_scan.cu — the RG-LRU linear recurrence, for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/rglru_scan/kernel.py::
// _kernel (launched by rglru_scan_kernel; the RG-LRU layers of the
// recurrentgemma prefill reach it through repro_torch.models.rglru::
// rglru_apply).  It computes the same function as
// src/repro_torch/kernels/rglru_scan/ref.py::rglru_scan_ref:
//
//   h[t, b, c] = a[t, b, c] * h[t-1, b, c] + x[t, b, c],  h[-1] = h0[b, c]
//
// for a, x (T, B, w) and h0 (B, w), all float32, h written (T, B, w)
// float32.
//
// Design: one thread per (b, c) lane of the (B, w) state, walking t in
// order with h in a register.  The TPU kernel solves each T-chunk by
// log-depth doubling on the vector unit; here the chain is a single FMA
// per step and the lanes are many, so the plain sequential walk does the
// least work.  Consecutive threads own consecutive columns, so every load
// and store of one step is coalesced along w.  The loads of kUnroll steps
// are issued before their FMAs, so each thread keeps 2 * kUnroll loads in
// flight: the FMA chain depends on h, the loads do not.  The sum is taken
// in another order than the reference's associative scan, so results
// agree to a tolerance (tests/test_kernels.py's 1e-4), not bit for bit.
//
// Bound on an NVIDIA H100 SXM (data-sheet rates, 700 W power limit):
// bytes.  The scan must read a and x once (8*T*B*w bytes), h0 (4*B*w)
// and write h (4*T*B*w); its 2*T*B*w flops are nothing beside that.  At
// the serve path's (512, 4, 2560) that is 63 MB, 18.8 us at 3.35 TB/s.
// With B*w = 10 240 lanes the launch has only 80 blocks of 128 threads,
// fewer than the card's 132 SMs, so the loads in flight, not the rate,
// bound this simple form (PERF.md has its measured time).
//
// Indices are 64-bit: T*B*w may pass 2^31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int64_t t_len, int64_t lanes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= lanes) return;
  float acc = h0[i];
  int64_t t = 0;
  for (; t + kUnroll <= t_len; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t idx = (t + u) * lanes + i;
      av[u] = a[idx];
      xv[u] = x[idx];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = fmaf(av[u], acc, xv[u]);
      h[(t + u) * lanes + i] = acc;
    }
  }
  for (; t < t_len; ++t) {
    const int64_t idx = t * lanes + i;
    acc = fmaf(a[idx], acc, x[idx]);
    h[idx] = acc;
  }
}

}  // namespace

// a, x, h: (t_len, lanes) row-major float32, lanes = B * w; h0: (lanes,).
extern "C" int rglru_scan_launch(const void* a, const void* x, const void* h0,
                                 void* h, long long t_len, long long lanes,
                                 void* stream) {
  if (t_len < 0 || lanes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(h), t_len, lanes);
  return static_cast<int>(cudaGetLastError());
}
