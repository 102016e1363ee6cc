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
// its innermost d-tile grid axis and casts at the last tile).  The TPU
// kernel's sequential d axis becomes a loop inside each block over
// d-tiles staged in shared memory by 16-byte `cp.async` copies, several
// stages deep, with f32 sums in registers; every weight byte is read
// from device memory once per launch.  Edges in C, D and F are guarded
// (zero-filled stages, masked stores), with no padding copies; when D or
// F leaves rows that are not whole 16-byte chunks the stages are filled
// element by element instead.  Offsets are 64-bit: one serve-path weight
// stack has 384 * 7168 * 2048 = 5.6e9 elements.  The launcher picks the
// design by dtype, in this one library, one launch per call:
//
// bfloat16 -> tensor cores (namespace tc).  A and B are swapped: the
// kernel computes out^T = w^T x^T, so that f (2 048 or 7 168) fills the
// MMA's 16-row M side and C (56 in prefill, 8 in decode) its N side; a
// 16-row C tile would compute 8 rows of zeros for 56 and 8 for 8.  One
// block of 8 warps per (256-column f tile, 8/16/32/64-slot C tile picked
// from C, expert); each warp owns 32 f columns (two 16 x 16 A tiles of w,
// read MN-major from shared memory and transposed by `ldmatrix.trans`)
// against all the block's slots (8-wide B tiles of x rows by `ldmatrix`),
// and runs `mma.sync.m16n8k16` (bf16 x bf16 -> f32: the products are
// exact, the sums f32).  d-tiles of 64 steps are staged three deep (two
// in flight, 66 KB of w per block; an SM holds one block at 64 slots, two
// at 8; 512-byte runs of each w row per block).  Each
// output sums over d in 16-step MMAs in d order, whatever C and the
// slot tile are, so a request's result does not depend on its batch.
// Bound on an NVIDIA H100 SXM (data-sheet rates, 700 W): at the serve
// path's prefill shapes, (384, 56, 7168) @ (384, 7168, 2048) and (384,
// 56, 2048) @ (384, 2048, 7168), the call reads x and w once and writes
// out once, 11 670 650 880 bytes (3.48 ms at 3.35 TB/s), and does 631
// GFLOP (0.64 ms at 989 TFLOP/s); in decode (C = 8) 11 330 912 256 bytes,
// 3.38 ms: bytes bound both, so the design's aim is the bytes in flight,
// not the MMA rate (181 TFLOP/s meets the bound in prefill, which
// `mma.sync` reaches; `wgmma` and TMA are the later step, PERF.md).
//
// float32 -> CUDA cores (namespace cc), the design of the first port:
// tensor cores cannot meet the f32 tolerance (tf32 keeps 10 mantissa
// bits).  One block of 8 warps per (128-column f tile, BM-row C tile,
// expert), BM 8/16/32/64 picked from C; x and w tiles of 32 d-steps three
// stages deep.  Lane j of warp r owns columns 4j..4j+3 of rows r, r + 8,
// ... of the tile: per d-step it reads its 4 columns of w (coalesced,
// conflict-free) and one broadcast x value per row, and does 4 * BM / 8
// f32 fused multiply-adds.  Bound: the products at the f32 CUDA-core
// rate, 67 TFLOP/s.
//
// Dynamic shared memory, above the 48 KB default (the launcher raises
// each instantiation's limit once): tc, 3 stages of a 64 x 264 w tile
// and an 8 NT x 72 x tile, 129 024 bytes at 64 slots; cc, 3 stages of BM
// x 32 x-elements and 32 x 128 w-elements, 73 728 bytes at BM 64.  x, w
// and out must start on 16-byte boundaries.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// ---- float32: the CUDA-core design ----------------------------------

namespace cc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 128;                  // f columns per block, 4 per lane
constexpr int kBK = 32;                   // d-steps per stage
constexpr int kStages = 3;                // stages in shared memory

// 4 adjacent elements at p (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// 4 adjacent elements to p (16-byte aligned)
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <int RPT>
constexpr int smem_bytes() {
  return kStages * (8 * RPT * kBK + kBK * kBN) *
         static_cast<int>(sizeof(float));
}

// Fill one stage: rows [c0, c0 + BM) x d-steps [k0, k0 + kBK) of this
// expert's x into xs, and d-steps [k0, k0 + kBK) x columns [f0, f0 +
// kBN) of its w into ws; zeros past C, D and F.  With `vec` (rows of x
// and w are multiples of 16 bytes) by cp.async, else element by element.
template <int BM>
__device__ __forceinline__ void stage(float* xs, float* ws, const float* xe,
                                      const float* we, int c0, int k0, int f0,
                                      int C, int D, int F, bool vec, int tid) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(float));   // per 16 bytes
  if (vec) {
    constexpr int CPRX = kBK / EPC;                        // chunks per row
    for (int c = tid; c < BM * CPRX; c += kThreads) {
      const int r = c / CPRX, k = (c % CPRX) * EPC;
      const bool ok = c0 + r < C && k0 + k < D;
      const float* src =
          ok ? xe + static_cast<int64_t>(c0 + r) * D + k0 + k : xe;
      cp_async16(xs + r * kBK + k, src, ok);
    }
    constexpr int CPRW = kBN / EPC;
    for (int c = tid; c < kBK * CPRW; c += kThreads) {
      const int k = c / CPRW, n = (c % CPRW) * EPC;
      const bool ok = k0 + k < D && f0 + n < F;
      const float* src =
          ok ? we + static_cast<int64_t>(k0 + k) * F + f0 + n : we;
      cp_async16(ws + k * kBN + n, src, ok);
    }
    return;
  }
  for (int i = tid; i < BM * kBK; i += kThreads) {
    const int r = i / kBK, k = i % kBK;
    xs[i] = c0 + r < C && k0 + k < D
                ? xe[static_cast<int64_t>(c0 + r) * D + k0 + k]
                : 0.0f;
  }
  for (int i = tid; i < kBK * kBN; i += kThreads) {
    const int k = i / kBN, n = i % kBN;
    ws[i] = k0 + k < D && f0 + n < F
                ? we[static_cast<int64_t>(k0 + k) * F + f0 + n]
                : 0.0f;
  }
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, int C, int D, int F, int vec) {
  constexpr int BM = 8 * RPT;             // rows of C per block
  extern __shared__ float4 smem4[];
  float* xs0 = reinterpret_cast<float*>(smem4);     // [stage][BM][kBK]
  float* ws0 = xs0 + kStages * BM * kBK;            // [stage][kBK][kBN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = blockIdx.x * kBN;
  const int c0 = blockIdx.y * BM;
  const int64_t e = blockIdx.z;
  const float* xe = x + e * C * D;
  const float* we = w + e * D * F;
  float* oe = out + e * C * F;
  const int n_k = (D + kBK - 1) / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      stage<BM>(xs0 + s * BM * kBK, ws0 + s * kBK * kBN, xe, we, c0,
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
      stage<BM>(xs0 + s * BM * kBK, ws0 + s * kBK * kBN, xe, we, c0,
                   next * kBK, f0, C, D, F, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();        // all but the newest: tile t is in
    __syncthreads();
    const float* xs = xs0 + (t % kStages) * BM * kBK;
    const float* ws = ws0 + (t % kStages) * kBK * kBN + 4 * lane;
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
    float* o = oe + static_cast<int64_t>(row) * F + col;
    if (vec) {                           // F is a multiple of 4: all 4 in
      store4(o, acc[i]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col + c < F) o[c] = acc[i][c];
      }
    }
  }
}

template <int RPT>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  constexpr int BM = 8 * RPT;
  constexpr int bytes = smem_bytes<RPT>();
  static bool attr_set = false;    // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        grouped_matmul_kernel<RPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int64_t c_tiles = (static_cast<int64_t>(C) + BM - 1) / BM;
  if (c_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (static_cast<int64_t>(D) * sizeof(float)) % 16 == 0 &&
                  (static_cast<int64_t>(F) * sizeof(float)) % 16 == 0;
  const dim3 grid((F + kBN - 1) / kBN, static_cast<unsigned>(c_tiles), E);
  grouped_matmul_kernel<RPT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), C, D, F, vec);
  return static_cast<int>(cudaGetLastError());
}

// The tile's row count from C: the smallest of 8, 16, 32, 64 rows that
// covers it (64 above).
int launch_rows(const void* x, const void* w, void* out, int E, int C, int D,
                int F, cudaStream_t s) {
  if (C <= 8) return launch<1>(x, w, out, E, C, D, F, s);
  if (C <= 16) return launch<2>(x, w, out, E, C, D, F, s);
  if (C <= 32) return launch<4>(x, w, out, E, C, D, F, s);
  return launch<8>(x, w, out, E, C, D, F, s);
}

}  // namespace cc

// ---- bfloat16: the tensor-core design --------------------------------

namespace tc {

constexpr int kBM = 256;        // f columns of out per block, 32 a warp
constexpr int kWarps = kBM / 32;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;         // d-steps per stage
constexpr int kStages = 3;      // stages in shared memory, 2 in flight
// padded shared-memory rows, in elements: 33 and 9 chunks of 16 bytes,
// odd, so the 8 rows that one ldmatrix reads fall on distinct banks
constexpr int kWS = kBM + 8;    // a w row (one d-step, kBM f columns)
constexpr int kXS = kBK + 8;    // an x row (one C slot, kBK d-steps)

// NT: 8-slot tiles of C per block (C is the MMA's N side)
template <int NT>
__host__ __device__ constexpr int stage_elems() {
  return kBK * kWS + 8 * NT * kXS;
}

template <int NT>
constexpr int smem_bytes() {
  return kStages * stage_elems<NT>() *
         static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and each thread receives row lane / 4, elements
// 2 (lane % 4), +1 of every matrix (of its transpose with `trans`)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 operands,
// f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fill one stage: d-steps [k0, k0 + kBK) x columns [f0, f0 + kBM) of
// this expert's w into ws, and slots [c0, c0 + 8 NT) x d-steps [k0, k0 +
// kBK) of its x into xs; zeros past C, D and F.  With `vec` (D and F
// multiples of 8: rows of x and w are whole 16-byte chunks, each chunk
// wholly inside or outside) by cp.async, else element by element.
template <int NT>
__device__ __forceinline__ void stage(__nv_bfloat16* ws, __nv_bfloat16* xs,
                                      const __nv_bfloat16* we,
                                      const __nv_bfloat16* xe, int c0,
                                      int k0, int f0, int C, int D, int F,
                                      bool vec, int tid) {
  constexpr int BN = 8 * NT;
  if (vec) {
    constexpr int CPRW = kBM / 8;                 // chunks per w row
    static_assert(kBK * CPRW % kThreads == 0, "whole copies per thread");
#pragma unroll
    for (int i = 0; i < kBK * CPRW / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int k = c / CPRW, n = (c % CPRW) * 8;
      const bool ok = k0 + k < D && f0 + n < F;
      cp_async16(ws + k * kWS + n,
                 ok ? we + static_cast<int64_t>(k0 + k) * F + f0 + n : we,
                 ok);
    }
    constexpr int CPRX = kBK / 8;                 // chunks per x row
    for (int c = tid; c < BN * CPRX; c += kThreads) {
      const int r = c / CPRX, k = (c % CPRX) * 8;
      const bool ok = c0 + r < C && k0 + k < D;
      cp_async16(xs + r * kXS + k,
                 ok ? xe + static_cast<int64_t>(c0 + r) * D + k0 + k : xe,
                 ok);
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = tid; i < kBK * kBM; i += kThreads) {
    const int k = i / kBM, n = i % kBM;
    ws[k * kWS + n] = k0 + k < D && f0 + n < F
                          ? we[static_cast<int64_t>(k0 + k) * F + f0 + n]
                          : zero;
  }
  for (int i = tid; i < BN * kBK; i += kThreads) {
    const int r = i / kBK, k = i % kBK;
    xs[r * kXS + k] = c0 + r < C && k0 + k < D
                          ? xe[static_cast<int64_t>(c0 + r) * D + k0 + k]
                          : zero;
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int C, int D, int F,
                      int vec) {
  constexpr int SE = stage_elems<NT>();
  extern __shared__ float4 smem4[];
  // [stage][w: kBK x kWS, then x: 8 NT x kXS]
  __nv_bfloat16* s0 = reinterpret_cast<__nv_bfloat16*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int m0 = (tid >> 5) * 32;         // this warp's first f column
  const int f0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * 8 * NT;
  const int64_t e = blockIdx.z;
  const __nv_bfloat16* xe = x + e * C * D;
  const __nv_bfloat16* we = w + e * D * F;
  __nv_bfloat16* oe = out + e * C * F;
  const int n_k = (D + kBK - 1) / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      stage<NT>(s0 + s * SE, s0 + s * SE + kBK * kWS, we, xe, c0, s * kBK,
                f0, C, D, F, vec, tid);
    }
    cp_async_commit();          // one group per stage, empty or not
  }

  // out^T = w^T x^T: the warp's 32 f columns are two 16-row A tiles (w
  // read MN-major, transposed by ldmatrix), the block's C slots NT 8-wide
  // B tiles (x rows, K-major as mma's column-major B wants)
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;
    }
  }

  for (int t = 0; t < n_k; ++t) {
    const int next = t + kStages - 1;    // its stage was consumed at t - 1
    if (next < n_k) {
      __nv_bfloat16* sn = s0 + (next % kStages) * SE;
      stage<NT>(sn, sn + kBK * kWS, we, xe, c0, next * kBK, f0, C, D, F,
                vec, tid);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();        // all but the newest: tile t is in
    __syncthreads();
    const __nv_bfloat16* ws = s0 + (t % kStages) * SE;
    const __nv_bfloat16* xs = ws + kBK * kWS;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm_x4_trans(a[mt], ws + (kk * 16 + (lane & 7) + (lane >> 4) * 8) *
                                      kWS +
                                  m0 + mt * 16 + ((lane >> 3) & 1) * 8);
      }
      if constexpr (NT == 1) {
        uint32_t bx[2];
        ldsm_x2(bx, xs + (lane & 7) * kXS + kk * 16 + ((lane >> 3) & 1) * 8);
        mma(acc[0][0], a[0], bx[0], bx[1]);
        mma(acc[1][0], a[1], bx[0], bx[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bx[4];
          ldsm_x4(bx, xs + (j * 8 + (lane & 7) + (lane >> 4) * 8) * kXS +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma(acc[0][j], a[0], bx[0], bx[1]);
          mma(acc[1][j], a[1], bx[0], bx[1]);
          mma(acc[0][j + 1], a[0], bx[2], bx[3]);
          mma(acc[1][j + 1], a[1], bx[2], bx[3]);
        }
      }
    }
    __syncthreads();                     // this stage is consumed
  }

  // accumulator (f, c) -> out[e, c, f], rounded once
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = f0 + m0 + mt * 16 + (lane >> 2) + (i >> 1) * 8;
        const int c = c0 + j * 8 + (lane & 3) * 2 + (i & 1);
        if (f < F && c < C) {
          oe[static_cast<int64_t>(c) * F + f] =
              __float2bfloat16_rn(acc[mt][j][i]);
        }
      }
    }
  }
}

template <int NT>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<NT>();
  static bool attr_set = false;    // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        grouped_matmul_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int64_t c_tiles = (static_cast<int64_t>(C) + 8 * NT - 1) / (8 * NT);
  if (c_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = D % 8 == 0 && F % 8 == 0;
  const dim3 grid((F + kBM - 1) / kBM, static_cast<unsigned>(c_tiles), E);
  grouped_matmul_kernel<NT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, D, F, vec);
  return static_cast<int>(cudaGetLastError());
}

// The tile's slot count from C: the smallest of 8, 16, 32, 64 that covers
// it (64 above).  Every choice sums over d in the same order.
int launch_slots(const void* x, const void* w, void* out, int E, int C,
                 int D, int F, cudaStream_t s) {
  if (C <= 8) return launch<1>(x, w, out, E, C, D, F, s);
  if (C <= 16) return launch<2>(x, w, out, E, C, D, F, s);
  if (C <= 32) return launch<4>(x, w, out, E, C, D, F, s);
  return launch<8>(x, w, out, E, C, D, F, s);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); x, w and
// out share it.  x (E, C, D), w (E, D, F), out (E, C, F), row-major;
// every dimension >= 1, E <= 65535; every pointer on a 16-byte boundary.
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
  if (dtype == 0) return cc::launch_rows(x, w, out, E, C, D, F, s);
  if (dtype == 1) return tc::launch_slots(x, w, out, E, C, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
