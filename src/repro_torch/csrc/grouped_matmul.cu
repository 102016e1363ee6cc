// grouped_matmul.cu — the MoE layer's grouped expert GEMM, for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/grouped_matmul/kernel.py::
// _kernel (launched by grouped_matmul_kernel; the port's MoE layer,
// repro_torch.models.moe::_expert_ffn, calls it three times per layer).
// It computes the same function as src/repro_torch/kernels/
// grouped_matmul/ref.py::grouped_matmul_ref:
//
//   out[e, c, n] = sum_k x[e, c, k] * w[e, k, n]
//
// x (E, C, D), w (E, D, F) and out (E, C, F) row-major, all float32 or
// all bfloat16; the sums are float32 and each output is rounded once to
// the inputs' type (the TPU kernel accumulates in f32 VMEM scratch over
// its innermost d-tile grid axis and casts at the last tile).
//
// Design: one block of 8 warps per (128-column f tile, BM-row C tile,
// expert).  The TPU kernel's sequential d axis becomes a loop inside the
// block: x and w tiles of 32 d-steps are staged in shared memory in the
// inputs' type, three stages deep, by 16-byte `cp.async` copies, so two
// tiles are in flight while the block computes on the third.  Lane j of
// warp r owns columns 4j..4j+3 of rows r, r + 8, ... of the tile (BM / 8
// rows, at most 8): per d-step it reads its 4 columns of w (neighbouring
// lanes on neighbouring addresses, so w is read along f, coalesced from
// device memory and free of bank conflicts in shared memory) and one x
// value per row (the same address for the whole warp: a broadcast), and
// does 4 * BM / 8 fused multiply-adds into float32 registers.  BM is 8,
// 16, 32 or 64, the smallest that covers C (64 above): the serve path's
// C is 56 in prefill and 8 in decode, so every block reads its w tile
// from device memory once and decode does not compute 56 rows of zeros.
// Edges in C, D and F are guarded (zero-filled stages, masked stores),
// with no padding copies; when a row of x or w is not a multiple of 16
// bytes the stages are filled element by element instead of by
// `cp.async`.  Offsets are 64-bit: one serve-path weight stack has
// 384 * 7168 * 2048 = 5.6e9 elements.  The products run on the CUDA
// cores in f32 (no tensor cores yet: mma.sync/wgmma and TMA are later
// work).
//
// Bound on an NVIDIA H100 SXM (data-sheet rates, 700 W power limit): at
// the serve path's prefill shapes, (384, 56, 7168) @ (384, 7168, 2048)
// and (384, 56, 2048) @ (384, 2048, 7168) in bf16, the function must
// read x and w once and write out once, 11 670 650 880 bytes (3.48 ms at
// 3.35 TB/s), and do 631 GFLOP (0.64 ms at the bf16 tensor rate of 989
// TFLOP/s): bytes bound it.  In decode (C = 8) it is 11 330 912 256
// bytes, 3.38 ms.  This form does its products at the f32 CUDA-core rate
// (67 TFLOP/s: 9.4 ms for the prefill's work), so in prefill it runs
// well above the bound (PERF.md has its measured time).
//
// Dynamic shared memory: 3 stages of BM x 32 x-elements and 32 x 128
// w-elements, 73 728 bytes at BM 64 in f32, above the 48 KB default: the
// launcher raises each instantiation's limit once.  x, w and out must
// start on 16-byte boundaries.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 128;                  // f columns per block, 4 per lane
constexpr int kBK = 32;                   // d-steps per stage
constexpr int kStages = 3;                // stages in shared memory

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 4 adjacent elements at p (16-byte aligned for f32, 8 for bf16) -> f32
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// f32 -> 4 adjacent elements at p, one rounding each
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(x[0], x[1]);
  h[1] = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// 16 bytes global -> shared without passing through registers; zeros
// instead when !valid (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int RPT, typename T>
constexpr int smem_bytes() {
  return kStages * (8 * RPT * kBK + kBK * kBN) * static_cast<int>(sizeof(T));
}

// Fill one stage: rows [c0, c0 + BM) x d-steps [k0, k0 + kBK) of this
// expert's x into xs, and d-steps [k0, k0 + kBK) x columns [f0, f0 +
// kBN) of its w into ws; zeros past C, D and F.  With `vec` (rows of x
// and w are multiples of 16 bytes) by cp.async, else element by element.
template <int BM, typename T>
__device__ __forceinline__ void stage(T* xs, T* ws, const T* xe, const T* we,
                                      int c0, int k0, int f0, int C, int D,
                                      int F, bool vec, int tid) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // per 16 bytes
  if (vec) {
    constexpr int CPRX = kBK / EPC;                        // chunks per row
    for (int c = tid; c < BM * CPRX; c += kThreads) {
      const int r = c / CPRX, k = (c % CPRX) * EPC;
      const bool ok = c0 + r < C && k0 + k < D;
      const T* src = ok ? xe + static_cast<int64_t>(c0 + r) * D + k0 + k : xe;
      cp_async16(xs + r * kBK + k, src, ok);
    }
    constexpr int CPRW = kBN / EPC;
    for (int c = tid; c < kBK * CPRW; c += kThreads) {
      const int k = c / CPRW, n = (c % CPRW) * EPC;
      const bool ok = k0 + k < D && f0 + n < F;
      const T* src = ok ? we + static_cast<int64_t>(k0 + k) * F + f0 + n : we;
      cp_async16(ws + k * kBN + n, src, ok);
    }
    return;
  }
  for (int i = tid; i < BM * kBK; i += kThreads) {
    const int r = i / kBK, k = i % kBK;
    xs[i] = c0 + r < C && k0 + k < D
                ? xe[static_cast<int64_t>(c0 + r) * D + k0 + k]
                : zero<T>();
  }
  for (int i = tid; i < kBK * kBN; i += kThreads) {
    const int k = i / kBN, n = i % kBN;
    ws[i] = k0 + k < D && f0 + n < F
                ? we[static_cast<int64_t>(k0 + k) * F + f0 + n]
                : zero<T>();
  }
}

template <int RPT, typename T>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      T* __restrict__ out, int C, int D, int F, int vec) {
  constexpr int BM = 8 * RPT;             // rows of C per block
  extern __shared__ float4 smem4[];
  T* xs0 = reinterpret_cast<T*>(smem4);                   // [stage][BM][kBK]
  T* ws0 = xs0 + kStages * BM * kBK;                      // [stage][kBK][kBN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = blockIdx.x * kBN;
  const int c0 = blockIdx.y * BM;
  const int64_t e = blockIdx.z;
  const T* xe = x + e * C * D;
  const T* we = w + e * D * F;
  T* oe = out + e * C * F;
  const int n_k = (D + kBK - 1) / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      stage<BM, T>(xs0 + s * BM * kBK, ws0 + s * kBK * kBN, xe, we, c0,
                   s * kBK, f0, C, D, F, vec, tid);
    }
    cp_async_commit();          // one group per stage, empty or not
  }

  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < n_k; ++t) {
    const int next = t + kStages - 1;    // its stage was consumed at t - 1
    if (next < n_k) {
      const int s = next % kStages;
      stage<BM, T>(xs0 + s * BM * kBK, ws0 + s * kBK * kBN, xe, we, c0,
                   next * kBK, f0, C, D, F, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();        // all but the newest: tile t is in
    __syncthreads();
    const T* xs = xs0 + (t % kStages) * BM * kBK;
    const T* ws = ws0 + (t % kStages) * kBK * kBN + 4 * lane;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float xv[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) load4(xs + (warp + 8 * i) * kBK + kk, xv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float wv[4];
        load4(ws + (kk + j) * kBN, wv);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xv[i][j], wv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();                     // this stage is consumed
  }

  const int col = f0 + 4 * lane;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = c0 + warp + 8 * i;
    if (row >= C || col >= F) continue;
    T* o = oe + static_cast<int64_t>(row) * F + col;
    if (vec) {                           // F is a multiple of 4: all 4 in
      store4(o, acc[i]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col + c < F) from_f32(o + c, acc[i][c]);
      }
    }
  }
}

template <int RPT, typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  constexpr int BM = 8 * RPT;
  constexpr int bytes = smem_bytes<RPT, T>();
  static bool attr_set = false;    // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        grouped_matmul_kernel<RPT, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int64_t c_tiles = (static_cast<int64_t>(C) + BM - 1) / BM;
  if (c_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (static_cast<int64_t>(D) * sizeof(T)) % 16 == 0 &&
                  (static_cast<int64_t>(F) * sizeof(T)) % 16 == 0;
  const dim3 grid((F + kBN - 1) / kBN, static_cast<unsigned>(c_tiles), E);
  grouped_matmul_kernel<RPT, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), C, D, F, vec);
  return static_cast<int>(cudaGetLastError());
}

// The tile's row count from C: the smallest of 8, 16, 32, 64 rows that
// covers it (64 above).
template <typename T>
int launch_rows(const void* x, const void* w, void* out, int E, int C, int D,
                int F, cudaStream_t s) {
  if (C <= 8) return launch<1, T>(x, w, out, E, C, D, F, s);
  if (C <= 16) return launch<2, T>(x, w, out, E, C, D, F, s);
  if (C <= 32) return launch<4, T>(x, w, out, E, C, D, F, s);
  return launch<8, T>(x, w, out, E, C, D, F, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).  x (E, C,
// D), w (E, D, F), out (E, C, F), row-major; every dimension >= 1, E <=
// 65535; every pointer on a 16-byte boundary.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out,
                                     int E, int C, int D, int F, int dtype,
                                     void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rows<float>(x, w, out, E, C, D, F, s);
  if (dtype == 1) {
    return launch_rows<__nv_bfloat16>(x, w, out, E, C, D, F, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
