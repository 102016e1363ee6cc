// colibri_scatter.cu — segmented commit of a key-sorted stream, for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/colibri_scatter/kernel.py::
// _kernel (launched by scatter_commit; reached from the simulator through
// repro.core.metrics.trace_latency_hist).  It computes the same function
// as src/repro_torch/kernels/colibri_scatter/ref.py::scatter_add_ref on a
// stream whose keys are sorted ascending:
//
//   out[b, :] = sum of vals[i, :] over the rows i with keys[i] == b,
//
// for every bin b in [0, bins), accumulated in f32 and written once in
// vals' dtype.  Keys outside [0, bins) are dropped (the Pallas kernel's
// one-hot drops them too).  Empty bins are written 0.
//
// Design: one thread block per bin.  The stream is sorted, so a bin's rows
// are one segment [lo, hi), found by two binary searches.  The block's
// threads tile (rows x columns): L lanes (a power of two <= min(d, 32))
// over columns and G = kThreads / L row groups over the segment, each
// thread summing its rows in an f32 register; a fixed-order tree over
// the G partial sums in shared memory gives each column's total, which
// the first row group writes.  No atomics: each bin is committed exactly
// once, by its own block (the paper's "commit once, never retry").  The
// sum's order differs from the TPU's per-512-row MXU blocks, so float
// outputs agree with the plain version to a tolerance, not bit for bit;
// integer-valued sums below 2^24 (histogram counts) are exact.
//
// Bound on this card: bytes.  The commit must read the keys (4T bytes)
// and the values (T*d*sizeof(val)) once and write the output
// (bins*d*sizeof(out)); its T*d additions are far below the f32 rate.
// The binary searches re-read ~2*log2(T) keys per bin, which stay in
// L2.  At the simulator's trace sizes (T <= 150 414, bins 64, d 1) that
// is about 1.2 MB, a third of a microsecond at 3.35 TB/s: the launch
// dominates.
//
// Indices are 64-bit: T*d may pass 2^31.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// first index i in [0, t) with keys[i] >= k (t if none)
__device__ int64_t lower_bound(const int32_t* keys, int64_t t, int32_t k) {
  int64_t lo = 0, hi = t;
  while (lo < hi) {
    int64_t mid = lo + (hi - lo) / 2;
    if (keys[mid] < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
colibri_commit_kernel(const int32_t* __restrict__ keys,
                      const T* __restrict__ vals, T* __restrict__ out,
                      int64_t t, int d, int lanes) {
  __shared__ int64_t seg[2];
  __shared__ float part[kThreads];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 2) seg[tid] = lower_bound(keys, t, b + tid);
  __syncthreads();
  const int64_t lo = seg[0], hi = seg[1];
  const int groups = kThreads / lanes;
  const int lane = tid % lanes, g = tid / lanes;
  for (int c0 = 0; c0 < d; c0 += lanes) {
    const int col = c0 + lane;
    float acc = 0.0f;
    if (col < d) {
      for (int64_t r = lo + g; r < hi; r += groups) {
        acc += load_f32(vals + r * d + col);
      }
    }
    part[tid] = acc;
    __syncthreads();
    for (int s = groups / 2; s > 0; s /= 2) {
      if (g < s) part[tid] += part[tid + s * lanes];
      __syncthreads();
    }
    if (g == 0 && col < d) {
      store(out + static_cast<int64_t>(b) * d + col, part[tid]);
    }
    __syncthreads();
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vals and out share it).  keys (t,)
// int32 sorted ascending; vals (t, d) and out (bins, d) row-major.
extern "C" int colibri_commit_launch(const void* keys, const void* vals,
                                     void* out, long long t, int d,
                                     int bins, int dtype, void* stream) {
  if (bins <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int lanes = 1;
  while (lanes * 2 <= d && lanes * 2 <= 32) lanes *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  if (dtype == 0) {
    colibri_commit_kernel<float><<<bins, kThreads, 0, s>>>(
        k, static_cast<const float*>(vals), static_cast<float*>(out), t, d,
        lanes);
  } else if (dtype == 1) {
    colibri_commit_kernel<__nv_bfloat16><<<bins, kThreads, 0, s>>>(
        k, static_cast<const __nv_bfloat16*>(vals),
        static_cast<__nv_bfloat16*>(out), t, d, lanes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
