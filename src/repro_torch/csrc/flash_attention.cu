// flash_attention.cu — streaming-softmax (flash) attention, for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py::
// _kernel (launched by flash_attention_kernel; the local- and global-
// attention layers of the LM prefill reach it through
// repro_torch.models.attention::gqa_apply).  It computes the same
// function as src/repro_torch/kernels/flash_attention/ref.py::
// attention_ref on the grouped-query layout of the reference op
// (src/repro/kernels/flash_attention/ops.py::flash_attention):
//
//   o[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, g]) v[b, j, g]
//
// with g = h / (H / KV), scale = hd^-0.5, j over [0, Skv), and j <= i when
// causal.  q, o are (B, Sq, H, hd) and k, v (B, Skv, KV, hd), row-major,
// all float32 or all bfloat16; the softmax statistics and the sums are
// float32, the output is written in the inputs' type.  The reference op
// repeats each KV head H/KV times before its kernel; this kernel reads
// query head h's KV head g in place instead, which is the same function.
//
// Design: one block of 4 warps per (32-row tile, b * KV + g).  The rows
// of a KV head are its query heads at each position, flattened as
// (position, head in the group): rows f = i * G + r of head g * G + r,
// G = H / KV.  So every K/V tile a block stages serves all G query heads
// that read it (ten at recurrentgemma-2b's 10-on-1 GQA), and the rows of
// a block span few positions, so a causal block masks little.  The block
// holds its query rows (pre-scaled, f32) in shared memory and walks the
// key axis in 32-key tiles.  K/V tiles stay in the inputs' type in shared
// memory, two stages deep: `cp.async` copies 16 bytes a request into one
// stage while the block computes on the other (the TPU kernel overlaps
// its copies through the BlockSpec pipeline; here the stages take that
// place).  Each warp owns 8 rows; lane j scores key j of the tile
// against them (16-byte loads of K, rows padded by 16 bytes so the 8
// lanes of each quarter-warp hit distinct banks), the warp reduces the
// running max and denominator with shuffles, and each lane accumulates
// ceil(hd/32) adjacent output columns of its 8 rows from the broadcast
// probabilities (at hd 112, kimi-k2-1t-a32b's, lanes 0-27 own 4 columns
// each and lanes 28-31 none; the staging loops take the remainder of
// 16-byte chunks that 128 threads do not divide).  The running max, denominator and accumulator stay in
// registers across key tiles (the TPU kernel carries them in VMEM
// scratch across its sequential grid axis).  Causal blocks stop at the
// tile holding their last row's position and are launched longest
// first; keys past the diagonal and past Skv are masked to probability
// 0.  The products run on the CUDA cores in f32 (no tensor cores yet:
// wgmma/TMA are later work).
//
// Bound on an NVIDIA H100 SXM (data-sheet rates, 700 W power limit): at
// the serve path's (B 4, S 512, H 10, KV 1, hd 256) bf16 causal shape the
// function must read q, k, v once and write o once, 23.1 MB (6.9 us at
// 3.35 TB/s), and do 5.38 GFLOP of causal products (5.4 us at the bf16
// tensor rate of 989 TFLOP/s): bytes bound it, barely.  This form does
// its products at the f32 CUDA-core rate (67 TFLOP/s, 80 us for that
// work), so it runs well above the bound (PERF.md has its measured
// time).
//
// Dynamic shared memory: 32 hd floats of queries and 2 stages of K and V
// tiles, 32 (hd + 16 / sizeof(T)) elements each: 100 352 bytes at hd 256
// in bf16, 165 888 in f32, above the 48 KB default: the launcher raises
// the kernel's limit once per instantiation.  q, k, v and o must start
// on 16-byte boundaries.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;       // query rows per block
constexpr int kBK = 32;                   // keys per tile (one per lane)
constexpr int kStages = 2;                // K/V tiles in flight
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// N adjacent elements at p -> f32, in the widest loads their alignment
// allows (16 bytes when N * sizeof(T) is a multiple of 16).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x;
      out[i + 1] = x.y;
      out[i + 2] = x.z;
      out[i + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      out[i] = x.x;
      out[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(h[j]);
        out[i + 2 * j] = x.x;
        out[i + 2 * j + 1] = x.y;
      }
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
      out[i] = x.x;
      out[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

// f32 -> N adjacent elements at p, widest stores first.
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      *reinterpret_cast<float2*>(p + i) = make_float2(x[i], x[i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = x[i];
  }
}

template <int N>
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, const float* x) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 raw;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = __floats2bfloat162_rn(x[i + 2 * j], x[i + 2 * j + 1]);
      }
      *reinterpret_cast<uint4*>(p + i) = raw;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      *reinterpret_cast<__nv_bfloat162*>(p + i) =
          __floats2bfloat162_rn(x[i], x[i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(x[i]);
  }
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

template <int HD, typename T>
__host__ __device__ constexpr int kv_row() {   // padded K/V row, in elements
  return HD + 16 / static_cast<int>(sizeof(T));
}

template <int HD, typename T>
constexpr int smem_bytes() {
  return kBQ * HD * static_cast<int>(sizeof(float)) +
         kStages * 2 * kBK * kv_row<HD, T>() * static_cast<int>(sizeof(T));
}

// Start copying keys [k0, k0 + kBK) of K and V into one stage (ks, vs).
template <int HD, typename T>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, const T* kb,
                                         const T* vb, int k0, int skv,
                                         int64_t kv_stride, int tid) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  constexpr int CPR = HD / EPC;                         // chunks per row
  constexpr int KS = kv_row<HD, T>();
  static_assert(HD % EPC == 0, "whole 16-byte chunks per row");
  constexpr int N = (kBK * CPR + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = tid + i * kThreads;
    if (N * kThreads != kBK * CPR && c >= kBK * CPR) break;
    const int j = c / CPR, col = (c % CPR) * EPC;
    const bool ok = k0 + j < skv;
    const int64_t off = (ok ? k0 + j : 0) * kv_stride + col;
    cp_async16(ks + j * KS + col, kb + off, ok);
    cp_async16(vs + j * KS + col, vb + off, ok);
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int skv, int heads, int kv_heads, int causal,
                       float scale) {
  constexpr int KS = kv_row<HD, T>();
  constexpr int DPL = (HD + 31) / 32;     // output columns per lane
  static_assert(HD % DPL == 0, "lanes own whole column groups");
  constexpr int QC = 8;                   // query elements per load
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);             // kBQ x HD
  T* kvs = reinterpret_cast<T*>(qs + kBQ * HD);  // [stage][K, V][kBK][KS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * kRows;           // this warp's first row
  // lanes past HD / DPL own no column (HD not a multiple of 32: 112)
  const bool col_ok = lane * DPL < HD;
  const int group = heads / kv_heads;
  const int rows = sq * group;                   // rows of this KV head
  const int f0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int b = blockIdx.y / kv_heads;
  const int g = blockIdx.y % kv_heads;
  const int64_t pos_stride = static_cast<int64_t>(heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * HD;
  const int64_t qo_base =
      (static_cast<int64_t>(b) * sq * heads + g * group) * HD;
  const T* kb = k + (static_cast<int64_t>(b) * skv * kv_heads + g) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * skv * kv_heads + g) * HD;
  // row f (< rows) -> its element offset in q and o from qo_base
  auto row_off = [&](int f) {
    return (f / group) * pos_stride + (f % group) * HD;
  };

  const int last = min(f0 + kBQ, rows) - 1;
  const int kv_end = causal ? min(skv, last / group + 1) : skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  stage_kv<HD, T>(kvs, kvs + kBK * KS, kb, vb, 0, skv, kv_stride, tid);
  cp_async_commit();

  static_assert(HD % QC == 0, "whole loads per row");
  constexpr int NQ = (kBQ * HD / QC + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int c = tid + i * kThreads;
    if (NQ * kThreads != kBQ * HD / QC && c >= kBQ * HD / QC) break;
    const int r = c / (HD / QC), col = (c % (HD / QC)) * QC;
    float x[QC];
    if (f0 + r < rows) {
      load_f32<QC>(q + qo_base + row_off(f0 + r) + col, x);
#pragma unroll
      for (int i = 0; i < QC; ++i) x[i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < QC; ++i) x[i] = 0.0f;
    }
    store_f32<QC>(qs + r * HD + col, x);
  }

  int qpos[kRows];
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    qpos[r] = (f0 + row0 + r) / group;
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {     // the next tile's stage was freed last pass
      T* nk = kvs + ((t + 1) % kStages) * 2 * kBK * KS;
      stage_kv<HD, T>(nk, nk + kBK * KS, kb, vb, (t + 1) * kBK, skv,
                      kv_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();      // all but the newest group: tile t is in
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kvs + (t % kStages) * 2 * kBK * KS;
    const T* vs = ks + kBK * KS;

    // scores of key t * kBK + lane against this warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const T* krow = ks + lane * KS;
#pragma unroll 2
    for (int d = 0; d < HD; d += 8) {
      float kk[8];
      load_f32<8>(krow + d, kk);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* qr = qs + (row0 + r) * HD + d;
        const float4 qa = *reinterpret_cast<const float4*>(qr);
        const float4 qb = *reinterpret_cast<const float4*>(qr + 4);
        s[r] = fmaf(qa.x, kk[0], s[r]);
        s[r] = fmaf(qa.y, kk[1], s[r]);
        s[r] = fmaf(qa.z, kk[2], s[r]);
        s[r] = fmaf(qa.w, kk[3], s[r]);
        s[r] = fmaf(qb.x, kk[4], s[r]);
        s[r] = fmaf(qb.y, kk[5], s[r]);
        s[r] = fmaf(qb.z, kk[6], s[r]);
        s[r] = fmaf(qb.w, kk[7], s[r]);
      }
    }

    // online softmax: s becomes this tile's probabilities
    const int kp = t * kBK + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = kp < skv && (!causal || kp <= qpos[r]);
      const float sv = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.0f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      s[r] = p;
    }

    // acc += P V over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DPL];
      if (col_ok) {
        load_f32<DPL>(vs + j * KS + lane * DPL, vv);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) vv[i] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
    __syncthreads();           // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int f = f0 + row0 + r;
    if (f < rows && col_ok) {
      const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= inv;
      store_f32<DPL>(o + qo_base + row_off(f) + lane * DPL, acc[r]);
    }
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int skv, int heads, int kv_heads, int causal, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD, T>();
  static bool attr_set = false;    // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int rows = sq * (heads / kv_heads);
  const dim3 grid((rows + kBQ - 1) / kBQ, batch * kv_heads);
  flash_attention_kernel<HD, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, heads, kv_heads,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int batch, int sq, int skv, int heads, int kv_heads, int causal,
              float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<32, T>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                           causal, scale, s);
    case 64:
      return launch<64, T>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                           causal, scale, s);
    case 112:
      return launch<112, T>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                            causal, scale, s);
    case 128:
      return launch<128, T>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                            causal, scale, s);
    case 256:
      return launch<256, T>(q, k, v, o, batch, sq, skv, heads, kv_heads,
                            causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  q, o
// (batch, sq, heads, hd) and k, v (batch, skv, kv_heads, hd), row-major;
// hd in {32, 64, 112, 128, 256}; heads a multiple of kv_heads; every pointer
// on a 16-byte boundary.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int sq, int skv, int heads,
                                      int kv_heads, int hd, int causal,
                                      float scale, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || batch * kv_heads > 65535 ||
      static_cast<int64_t>(sq) * (heads / kv_heads) > (1 << 30) ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_hd<float>(hd, q, k, v, o, batch, sq, skv, heads, kv_heads,
                            causal, scale, s);
  }
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, batch, sq, skv, heads,
                                    kv_heads, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
