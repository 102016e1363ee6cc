// flash_attention_bwd.cu — the gradient of flash attention, for Hopper.
//
// Replaces no Pallas kernel: the reference differentiates its plain
// blocked_attention (src/repro/models/attention.py:62) through XLA, and
// no Pallas kernel of the repository has a backward.  The port's models
// call the flash_attention kernel (flash_attention.cu) on their training
// path too, so its gradient is a kernel here: the backward of
// repro_torch.kernels.flash_attention.ops.FlashAttention, and of nothing
// else.  It computes the same function as src/repro_torch/kernels/
// flash_attention/ref.py::flash_attention_bwd_ref.  With S = scale Q K^T
// (scale = hd^-0.5, keys j <= i when causal), P = softmax(S) and O = P V,
// for one query head h of KV head g = h / (H / KV):
//
//   D   = rowsum(dO o O)                       (f32, per query row)
//   P   = exp(S - lse)                         (recomputed; lse from the
//                                               forward, flash_attention.cu)
//   dS  = P o (dO V^T - D)
//   dQ  = scale dS K,   dK = scale sum_h dS^T Q,   dV = sum_h P^T dO
//
// q, o, do, dq are (B, Sq, H, hd) and k, v, dk, dv (B, Skv, KV, hd),
// row-major, all float32 or all bfloat16; lse and D are float32 (B, H,
// Sq).  Two launches, on the caller's stream, in this order:
//
// dq  — one block per (64-row query tile, b, h), longest causal tiles
//       first.  It writes D for its rows (read by the second launch), then
//       walks the key tiles (causal: up to its last row's position),
//       recomputing S and dO V^T, and accumulates dS K in f32 registers.
// dkdv — one block per (64-key tile, b, g).  It walks the H / KV query
//       heads of the group and, for each, the query tiles (causal: from the
//       tile holding its first key on), recomputing S^T and V dO^T, and
//       accumulates P^T dO and dS^T Q in f32 registers.  The sum over the
//       group's heads happens inside the block, in a fixed order.
//
// Every output element is written once by one thread after a fixed
// sequence of f32 operations: no atomics, so two launches on the same
// inputs give the same bits.  Rows and keys past Sq and Skv are staged as
// zeros and masked to P = 0; they are never written.
//
// bfloat16 -> tensor cores (namespace tc): 4 warps of 16 rows, products by
// `mma.sync.m16n8k16` (bf16 x bf16 -> f32) with operands from shared memory
// by `ldmatrix` (`.trans` for the right-hand tile of dS K, P^T dO and
// dS^T Q) and the left-hand P or dS from registers, rounded to bf16 once
// (the plain version keeps them in f32); softmax math in f32, exp as one
// MUFU ex2.  Tiles of 32 on the loop side, staged by 16-byte `cp.async`,
// one stage.
// float32 -> CUDA cores (namespace cc): 8 warps of 8 rows, lane j scores
// the tile's row j of the other side; the products' sums are fma chains
// per lane and shuffles broadcast P and dS, as in flash_attention.cu's cc
// design.  Tensor cores cannot meet the f32 tolerance (tf32).
//
// Head dims 32, 64, 112 and 128; the launchers refuse others.
//
// Bound on an NVIDIA H100 SXM (data-sheet rates, 700 W) at smollm-135m's
// training shape (B 8, S 4 096, H 9, KV 3, hd 64, causal, bf16): the five
// products of the gradient over the 604 127 232 unmasked (query, key)
// pairs, 2 hd flops each, are 3.87e11 flops (0.391 ms at 989 TFLOP/s);
// reading q, k, v, o, do, lse once and writing dq, dk, dv once is 202.4 MB
// (0.060 ms at 3.35 TB/s): operations bound it.  This design recomputes S
// and dO V^T in both launches (7 products, not 5) and uses `mma.sync`, not
// `wgmma`: a simple kernel that is right first.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#ifndef CUDA_CPU_MOCK  // tests/test_torch_flash_bwd_cpu.py supplies these
// 16 bytes global -> shared; zeros instead when !valid (the source is then
// not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// wait for every copy this thread started
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and each thread receives row lane / 4, elements
// 2 (lane % 4), +1 of every matrix (of its transpose with `trans`)
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

// 2^x in one MUFU instruction
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
#endif

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the shapes of one call
struct Dims {
  int batch, sq, skv, heads, kv_heads, causal;
  float scale;
};

// ---- float32: the CUDA-core design ----------------------------------

namespace cc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;                  // rows per warp
constexpr int kBR = kWarps * kRows;       // a block's rows: 64
constexpr int kBT = 32;                   // the loop side's tile, one a lane

template <int HD>
__host__ __device__ constexpr int pad_row() {  // a lane-read row, in floats
  return HD + 4;
}

template <int HD>
constexpr int smem_bytes() {
  return (2 * kBR * HD + 2 * kBT * pad_row<HD>() + 2 * kBT) *
         static_cast<int>(sizeof(float));
}

// n_rows rows of hd floats, row r from src + r * stride, into dst rows of
// dst_stride, zeros past `valid` rows, times `mul`
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const float* src, int64_t stride,
                                          int n_rows, int valid, float mul,
                                          int tid) {
  constexpr int C = HD / 4;  // float4 chunks a row
  for (int c = tid; c < n_rows * C; c += kThreads) {
    const int r = c / C, col = (c % C) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) {
      x = *reinterpret_cast<const float4*>(src + r * stride + col);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * dst_stride + col) = x;
  }
}

// sum_d a[d] * b[d] over hd, a broadcast (a warp's row), b a lane's row
template <int HD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// acc[r][i] += sum_j w_j[r] * t[j][lane * DPL + i] over the kBT rows of
// t (stride TS), w_j[r] lane j's w[r]
template <int HD, int TS>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][(HD + 31) / 32],
                                           const float (&w)[kRows],
                                           const float* t, int lane) {
  constexpr int DPL = (HD + 31) / 32;
  const bool col_ok = lane * DPL < HD;
#pragma unroll 4
  for (int j = 0; j < kBT; ++j) {
    float tv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      tv[i] = col_ok ? t[j * TS + lane * DPL + i] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float wj = __shfl_sync(kFull, w[r], j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(wj, tv[i], acc[r][i]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void store_rows(float* dst, int64_t stride,
                                           const float (&acc)[kRows]
                                                             [(HD + 31) / 32],
                                           int row0, int valid, float mul,
                                           int lane) {
  constexpr int DPL = (HD + 31) / 32;
  if (lane * DPL >= HD) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r < valid) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        dst[(row0 + r) * stride + lane * DPL + i] = acc[r][i] * mul;
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq, Dims p) {
  constexpr int KS = pad_row<HD>();
  constexpr int DPL = (HD + 31) / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kBR x HD, times scale
  float* dos = qs + kBR * HD;                    // kBR x HD
  float* ks = dos + kBR * HD;                    // kBT x KS
  float* vs = ks + kBT * KS;                     // kBT x KS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (p.sq + kBR - 1) / kBR;
  const int bh = blockIdx.x % (p.batch * p.heads);
  const int q0 = (n_tiles - 1 - blockIdx.x / (p.batch * p.heads)) * kBR;
  const int b = bh / p.heads, h = bh % p.heads;
  const int g = h / (p.heads / p.kv_heads);
  const int64_t pos_stride = static_cast<int64_t>(p.heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(p.kv_heads) * HD;
  const int64_t qo = (static_cast<int64_t>(b) * p.sq + q0) * pos_stride +
                     static_cast<int64_t>(h) * HD;
  const int64_t kvb = static_cast<int64_t>(b) * p.skv * kv_stride +
                      static_cast<int64_t>(g) * HD;
  const int64_t row_stat = static_cast<int64_t>(bh) * p.sq + q0;
  const int valid = min(kBR, p.sq - q0);

  load_rows<HD>(qs, HD, q + qo, pos_stride, kBR, valid, p.scale, tid);
  load_rows<HD>(dos, HD, dout + qo, pos_stride, kBR, valid, 1.0f, tid);

  // D and lse of this warp's rows (uniform across the warp)
  const int row0 = warp * kRows;
  float dd[kRows], ll[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r;
    float part = 0.0f;
    if (i < valid) {
      for (int c = lane; c < HD; c += 32) {
        part = fmaf(o[qo + i * pos_stride + c], dout[qo + i * pos_stride + c],
                    part);
      }
    }
    dd[r] = warp_sum(part);
    ll[r] = i < valid ? lse[row_stat + i] : 0.0f;
    if (i < valid && lane == 0) delta[row_stat + i] = dd[r];
  }

  float acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }

  const int kv_end = p.causal ? min(p.skv, q0 + valid) : p.skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBT) {
    const int nk = min(kBT, p.skv - k0);
    __syncthreads();   // the previous tile is consumed (and qs, dos in)
    load_rows<HD>(ks, KS, k + kvb + k0 * kv_stride, kv_stride, kBT, nk, 1.0f,
                  tid);
    load_rows<HD>(vs, KS, v + kvb + k0 * kv_stride, kv_stride, kBT, nk, 1.0f,
                  tid);
    __syncthreads();
    const int key = k0 + lane;
    float ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = row0 + r;
      const float s = dot<HD>(qs + i * HD, ks + lane * KS);
      const float dp = dot<HD>(dos + i * HD, vs + lane * KS);
      const bool ok = i < valid && key < p.skv && (!p.causal || key <= q0 + i);
      const float pr = ok ? expf(s - ll[r]) : 0.0f;
      ds[r] = pr * (dp - dd[r]);
    }
    accumulate<HD, KS>(acc, ds, ks, lane);
  }
  store_rows<HD>(dq + qo, pos_stride, acc, row0, valid, p.scale, lane);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, Dims p) {
  constexpr int KS = pad_row<HD>();
  constexpr int DPL = (HD + 31) / 32;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // kBR x HD
  float* vs = ks + kBR * HD;                     // kBR x HD
  float* qs = vs + kBR * HD;                     // kBT x KS, times scale
  float* dos = qs + kBT * KS;                    // kBT x KS
  float* ls = dos + kBT * KS;                    // kBT lse
  float* dl = ls + kBT;                          // kBT D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = p.heads / p.kv_heads;
  const int bg = blockIdx.x % (p.batch * p.kv_heads);
  const int k0 = blockIdx.x / (p.batch * p.kv_heads) * kBR;  // longest first
  const int b = bg / p.kv_heads, g = bg % p.kv_heads;
  const int64_t pos_stride = static_cast<int64_t>(p.heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(p.kv_heads) * HD;
  const int64_t kvo = (static_cast<int64_t>(b) * p.skv + k0) * kv_stride +
                      static_cast<int64_t>(g) * HD;
  const int valid = min(kBR, p.skv - k0);
  load_rows<HD>(ks, HD, k + kvo, kv_stride, kBR, valid, 1.0f, tid);
  load_rows<HD>(vs, HD, v + kvo, kv_stride, kBR, valid, 1.0f, tid);

  const int row0 = warp * kRows;
  float dka[kRows][DPL], dva[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) dka[r][i] = dva[r][i] = 0.0f;
  }

  const int u0 = p.causal ? k0 / kBT * kBT : 0;
  for (int hr = 0; hr < group; ++hr) {
    const int h = g * group + hr;
    const int64_t stat = (static_cast<int64_t>(b) * p.heads + h) * p.sq;
    for (int q0 = u0; q0 < p.sq; q0 += kBT) {
      const int nq = min(kBT, p.sq - q0);
      const int64_t qo = (static_cast<int64_t>(b) * p.sq + q0) * pos_stride +
                         static_cast<int64_t>(h) * HD;
      __syncthreads();   // the previous tile is consumed (and ks, vs in)
      load_rows<HD>(qs, KS, q + qo, pos_stride, kBT, nq, p.scale, tid);
      load_rows<HD>(dos, KS, dout + qo, pos_stride, kBT, nq, 1.0f, tid);
      if (tid < kBT) {
        ls[tid] = tid < nq ? lse[stat + q0 + tid] : 0.0f;
        dl[tid] = tid < nq ? delta[stat + q0 + tid] : 0.0f;
      }
      __syncthreads();
      const int qi = q0 + lane;
      float pr[kRows], ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = k0 + row0 + r;
        const float s = dot<HD>(ks + (row0 + r) * HD, qs + lane * KS);
        const float dp = dot<HD>(vs + (row0 + r) * HD, dos + lane * KS);
        const bool ok = lane < nq && row0 + r < valid &&
                        (!p.causal || key <= qi);
        pr[r] = ok ? expf(s - ls[lane]) : 0.0f;
        ds[r] = pr[r] * (dp - dl[lane]);
      }
      accumulate<HD, KS>(dva, pr, dos, lane);
      accumulate<HD, KS>(dka, ds, qs, lane);   // qs is scaled: dK's scale
    }
  }
  store_rows<HD>(dk + kvo, kv_stride, dka, row0, valid, 1.0f, lane);
  store_rows<HD>(dv + kvo, kv_stride, dva, row0, valid, 1.0f, lane);
}

}  // namespace cc

// ---- bfloat16: the tensor-core design --------------------------------

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBR = 16 * kWarps;          // a block's rows: 64, 16 a warp
constexpr int kBT = 32;                   // the loop side's tile

template <int HD>
struct Cfg {
  // a shared-memory row of hd elements, padded by 16 bytes: hd / 8 + 1
  // chunks of 16 bytes is odd for every head dim, so the 8 rows that one
  // ldmatrix reads fall on distinct banks
  static constexpr int kRow = HD + 8;
  static constexpr int kSmemBytes =
      (2 * kBR + 2 * kBT) * kRow * static_cast<int>(sizeof(__nv_bfloat16)) +
      2 * kBT * static_cast<int>(sizeof(float));
};

// (lo, hi) -> one register of two bf16, lo in the low half, each rounded
// to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// n_rows rows of HD bf16, row r from src + r * stride, into dst rows of
// Cfg<HD>::kRow, zeros past `valid` rows
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int n_rows,
                                           int valid, int tid) {
  constexpr int RS = Cfg<HD>::kRow, CPR = HD / 8;
  for (int c = tid; c < n_rows * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * RS + col, src + (ok ? r * stride + col : 0), ok);
  }
}

// s = a (the warp's 16 rows, stride RS) . b^T (N rows, stride RS) over HD,
// in the mma accumulator layout: s[j][e] is row g + 8 (e / 2), column
// 8 j + 2 t + e % 2 (g = lane / 4, t = lane % 4)
template <int HD, int N>
__device__ __forceinline__ void rows_by_rows(float (&s)[N / 8][4],
                                             const __nv_bfloat16* a,
                                             const __nv_bfloat16* b,
                                             int lane) {
  constexpr int RS = Cfg<HD>::kRow;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (j * 8 + (lane & 7) + (lane >> 4) * 8) * RS + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma(s[j], af, bf[0], bf[1]);
      mma(s[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc += w (16 x N, bf16 pairs in the accumulator layout: w[j][r] holds
// row g + 8 r, columns 8 j + 2 t, +1) . t (N rows x HD, stride RS)
template <int HD, int N>
__device__ __forceinline__ void regs_by_rows(float (&acc)[HD / 8][4],
                                             const uint32_t (&w)[N / 8][2],
                                             const __nv_bfloat16* t,
                                             int lane) {
  constexpr int RS = Cfg<HD>::kRow;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t a[4] = {w[2 * kk][0], w[2 * kk][1], w[2 * kk + 1][0],
                           w[2 * kk + 1][1]};
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                RS + n * 8 + (lane >> 4) * 8);
      mma(acc[n], a, bf[0], bf[1]);
      mma(acc[n + 1], a, bf[2], bf[3]);
    }
  }
}

// the warp's 16 rows of acc, times mul, as bf16 to dst rows (stride
// elements apart), rows at or past `valid` (from the warp's first) skipped
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, int64_t stride,
                                          const float (&acc)[HD / 8][4],
                                          int valid, float mul, int lane) {
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= valid) continue;
    __nv_bfloat16* row = dst + (r0 + 8 * r) * stride + c0;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, Dims p) {
  constexpr int RS = Cfg<HD>::kRow, NT = kBT / 8, NO = HD / 8;
  static_assert(HD % 16 == 0 && NO % 2 == 0, "whole k-steps and pairs");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // kBR x RS
  __nv_bfloat16* dos = qs + kBR * RS;                           // kBR x RS
  __nv_bfloat16* ks = dos + kBR * RS;                           // kBT x RS
  __nv_bfloat16* vs = ks + kBT * RS;                            // kBT x RS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (p.sq + kBR - 1) / kBR;
  const int bh = blockIdx.x % (p.batch * p.heads);
  const int q0 = (n_tiles - 1 - blockIdx.x / (p.batch * p.heads)) * kBR;
  const int b = bh / p.heads, h = bh % p.heads;
  const int g = h / (p.heads / p.kv_heads);
  const int64_t pos_stride = static_cast<int64_t>(p.heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(p.kv_heads) * HD;
  const int64_t qo = (static_cast<int64_t>(b) * p.sq + q0) * pos_stride +
                     static_cast<int64_t>(h) * HD;
  const int64_t kvb = static_cast<int64_t>(b) * p.skv * kv_stride +
                      static_cast<int64_t>(g) * HD;
  const int64_t row_stat = static_cast<int64_t>(bh) * p.sq + q0;
  const int valid = min(kBR, p.sq - q0);
  const int wrow = warp * 16;

  stage_rows<HD>(qs, q + qo, pos_stride, kBR, valid, tid);
  stage_rows<HD>(dos, dout + qo, pos_stride, kBR, valid, tid);

  // D of the warp's 16 rows (f32 from the bf16 o and do), written for the
  // dkdv launch; this thread keeps rows g and g + 8 with their lse
  float dd[2] = {0.0f, 0.0f}, l2[2] = {0.0f, 0.0f};
  for (int rr = 0; rr < 16; ++rr) {
    const int i = wrow + rr;
    float part = 0.0f;
    if (i < valid) {
      for (int c = lane; c < HD; c += 32) {
        part = fmaf(__bfloat162float(o[qo + i * pos_stride + c]),
                    __bfloat162float(dout[qo + i * pos_stride + c]), part);
      }
    }
    part = warp_sum(part);
    if (i < valid && lane == 0) delta[row_stat + i] = part;
    if (rr == (lane >> 2)) dd[0] = part;
    if (rr == (lane >> 2) + 8) dd[1] = part;
  }
  int pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wrow + (lane >> 2) + 8 * r;
    pos[r] = q0 + i;
    l2[r] = i < valid ? lse[row_stat + i] * kLog2e : 0.0f;
  }
  const float sl = p.scale * kLog2e;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }

  const int kv_end = p.causal ? min(p.skv, q0 + valid) : p.skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBT) {
    const int nk = min(kBT, p.skv - k0);
    __syncthreads();   // the previous tile is consumed
    stage_rows<HD>(ks, k + kvb + k0 * kv_stride, kv_stride, kBT, nk, tid);
    stage_rows<HD>(vs, v + kvb + k0 * kv_stride, kv_stride, kBT, nk, tid);
    cp_async_wait_all();
    __syncthreads();
    float s[NT][4], dp[NT][4];
    rows_by_rows<HD, kBT>(s, qs + wrow * RS, ks, lane);
    rows_by_rows<HD, kBT>(dp, dos + wrow * RS, vs, lane);
    uint32_t dsb[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
        const int r = e >> 1;
        const bool ok = pos[r] < q0 + valid && key < p.skv &&
                        (!p.causal || key <= pos[r]);
        const float pr = ok ? ex2(fmaf(s[j][e], sl, -l2[r])) : 0.0f;
        ds[e] = pr * (dp[j][e] - dd[r]);
      }
      dsb[j][0] = pack_bf16(ds[0], ds[1]);
      dsb[j][1] = pack_bf16(ds[2], ds[3]);
    }
    regs_by_rows<HD, kBT>(acc, dsb, ks, lane);
  }
  store_acc<HD>(dq + qo + wrow * pos_stride, pos_stride, acc, valid - wrow,
                p.scale, lane);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            Dims p) {
  constexpr int RS = Cfg<HD>::kRow, NT = kBT / 8, NO = HD / 8;
  static_assert(HD % 16 == 0 && NO % 2 == 0, "whole k-steps and pairs");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem4);  // kBR x RS
  __nv_bfloat16* vs = ks + kBR * RS;                            // kBR x RS
  __nv_bfloat16* qs = vs + kBR * RS;                            // kBT x RS
  __nv_bfloat16* dos = qs + kBT * RS;                           // kBT x RS
  float* ls = reinterpret_cast<float*>(dos + kBT * RS);  // kBT lse, log2
  float* dl = ls + kBT;                                   // kBT D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = p.heads / p.kv_heads;
  const int bg = blockIdx.x % (p.batch * p.kv_heads);
  const int k0 = blockIdx.x / (p.batch * p.kv_heads) * kBR;  // longest first
  const int b = bg / p.kv_heads, g = bg % p.kv_heads;
  const int64_t pos_stride = static_cast<int64_t>(p.heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(p.kv_heads) * HD;
  const int64_t kvo = (static_cast<int64_t>(b) * p.skv + k0) * kv_stride +
                      static_cast<int64_t>(g) * HD;
  const int valid = min(kBR, p.skv - k0);
  const int wrow = warp * 16;
  stage_rows<HD>(ks, k + kvo, kv_stride, kBR, valid, tid);
  stage_rows<HD>(vs, v + kvo, kv_stride, kBR, valid, tid);

  int key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key[r] = k0 + wrow + (lane >> 2) + 8 * r;
  const float sl = p.scale * kLog2e;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;
  }

  const int u0 = p.causal ? k0 / kBT * kBT : 0;
  for (int hr = 0; hr < group; ++hr) {
    const int h = g * group + hr;
    const int64_t stat = (static_cast<int64_t>(b) * p.heads + h) * p.sq;
    for (int q0 = u0; q0 < p.sq; q0 += kBT) {
      const int nq = min(kBT, p.sq - q0);
      const int64_t qo = (static_cast<int64_t>(b) * p.sq + q0) * pos_stride +
                         static_cast<int64_t>(h) * HD;
      __syncthreads();   // the previous tile is consumed
      stage_rows<HD>(qs, q + qo, pos_stride, kBT, nq, tid);
      stage_rows<HD>(dos, dout + qo, pos_stride, kBT, nq, tid);
      if (tid < kBT) {
        ls[tid] = tid < nq ? lse[stat + q0 + tid] * kLog2e : 0.0f;
        dl[tid] = tid < nq ? delta[stat + q0 + tid] : 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();
      float s[NT][4], dp[NT][4];
      rows_by_rows<HD, kBT>(s, ks + wrow * RS, qs, lane);
      rows_by_rows<HD, kBT>(dp, vs + wrow * RS, dos, lane);
      uint32_t pb[NT][2], dsb[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float pr[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + (lane & 3) * 2 + (e & 1);
          const int kr = key[e >> 1];
          const bool ok = c < nq && kr < k0 + valid &&
                          (!p.causal || kr <= q0 + c);
          pr[e] = ok ? ex2(fmaf(s[j][e], sl, -ls[c])) : 0.0f;
          ds[e] = pr[e] * (dp[j][e] - dl[c]);
        }
        pb[j][0] = pack_bf16(pr[0], pr[1]);
        pb[j][1] = pack_bf16(pr[2], pr[3]);
        dsb[j][0] = pack_bf16(ds[0], ds[1]);
        dsb[j][1] = pack_bf16(ds[2], ds[3]);
      }
      regs_by_rows<HD, kBT>(dva, pb, dos, lane);
      regs_by_rows<HD, kBT>(dka, dsb, qs, lane);
    }
  }
  store_acc<HD>(dk + kvo + wrow * kv_stride, kv_stride, dka, valid - wrow,
                p.scale, lane);
  store_acc<HD>(dv + kvo + wrow * kv_stride, kv_stride, dva, valid - wrow,
                1.0f, lane);
}

}  // namespace tc

// Raise each instantiation's dynamic shared-memory limit once.
template <class K>
int allow_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <int HD>
int launch_dq(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* delta,
              void* dq, const Dims& p, cudaStream_t s) {
  const int grid = (p.sq + 63) / 64 * p.batch * p.heads;
  if (dtype == 0) {
    static bool done = false;
    constexpr int bytes = cc::smem_bytes<HD>();
    if (int err = allow_smem(cc::dq_kernel<HD>, bytes, done)) return err;
    cc::dq_kernel<HD><<<grid, cc::kThreads, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
        p);
  } else {
    static bool done = false;
    constexpr int bytes = tc::Cfg<HD>::kSmemBytes;
    if (int err = allow_smem(tc::dq_kernel<HD>, bytes, done)) return err;
    tc::dq_kernel<HD><<<grid, tc::kThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkdv(int dtype, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, const Dims& p, cudaStream_t s) {
  const int grid = (p.skv + 63) / 64 * p.batch * p.kv_heads;
  if (dtype == 0) {
    static bool done = false;
    constexpr int bytes = cc::smem_bytes<HD>();
    if (int err = allow_smem(cc::dkdv_kernel<HD>, bytes, done)) return err;
    cc::dkdv_kernel<HD><<<grid, cc::kThreads, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), p);
  } else {
    static bool done = false;
    constexpr int bytes = tc::Cfg<HD>::kSmemBytes;
    if (int err = allow_smem(tc::dkdv_kernel<HD>, bytes, done)) return err;
    tc::dkdv_kernel<HD><<<grid, tc::kThreads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), p);
  }
  return static_cast<int>(cudaGetLastError());
}

bool dims_ok(const Dims& p, int hd, int dtype, uintptr_t ptrs) {
  return p.batch > 0 && p.sq > 0 && p.skv > 0 && p.kv_heads > 0 &&
         p.heads % p.kv_heads == 0 && (dtype == 0 || dtype == 1) &&
         (hd == 32 || hd == 64 || hd == 112 || hd == 128) &&
         static_cast<int64_t>((p.sq + 63) / 64) * p.batch * p.heads <
             (int64_t{1} << 31) &&
         (ptrs & 15) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do and the gradients share
// it).  q, o, do, dq (batch, sq, heads, hd) and k, v, dk, dv (batch, skv,
// kv_heads, hd), row-major; lse (the forward's) and delta (written here) f32
// (batch, heads, sq); hd in {32, 64, 112, 128}; heads a multiple of
// kv_heads; q, k, v, o, do, dq, dk, dv on 16-byte boundaries.  Launch dq
// first: dkdv reads its delta.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, int batch,
    int sq, int skv, int heads, int kv_heads, int hd, int causal, float scale,
    int dtype, void* stream) {
  const Dims p{batch, sq, skv, heads, kv_heads, causal, scale};
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq);
  if (!dims_ok(p, hd, dtype, ptrs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_dq<32>(dtype, q, k, v, o, dout, lse, delta, dq, p, s);
    case 64:
      return launch_dq<64>(dtype, q, k, v, o, dout, lse, delta, dq, p, s);
    case 112:
      return launch_dq<112>(dtype, q, k, v, o, dout, lse, delta, dq, p, s);
    default:
      return launch_dq<128>(dtype, q, k, v, o, dout, lse, delta, dq, p, s);
  }
}

extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int batch,
    int sq, int skv, int heads, int kv_heads, int hd, int causal, float scale,
    int dtype, void* stream) {
  const Dims p{batch, sq, skv, heads, kv_heads, causal, scale};
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (!dims_ok(p, hd, dtype, ptrs) ||
      static_cast<int64_t>((skv + 63) / 64) * batch * kv_heads >=
          (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_dkdv<32>(dtype, q, k, v, dout, lse, delta, dk, dv, p, s);
    case 64:
      return launch_dkdv<64>(dtype, q, k, v, dout, lse, delta, dk, dv, p, s);
    case 112:
      return launch_dkdv<112>(dtype, q, k, v, dout, lse, delta, dk, dv, p,
                              s);
    default:
      return launch_dkdv<128>(dtype, q, k, v, dout, lse, delta, dk, dv, p,
                              s);
  }
}
