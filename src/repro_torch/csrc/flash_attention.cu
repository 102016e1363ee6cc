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
// causal; with a window W > 0 (causal only) also i - j < W, the band of
// the reference's sliding_window_attention (src/repro/models/
// attention.py::sliding_window_attention), which the local layers of the
// LM prefill take.  q is (B, Sq, H, hd), k (B, Skv, KV, hd), v (B, Skv,
// KV, hdv) and o (B, Sq, H, hdv), row-major, all float32 or all bfloat16;
// hdv is hd, or 128 under hd 192 (MLA's q/k of 128 + 64 against its v of
// 128: src/repro/models/attention.py::mla_apply pads v to 192 instead,
// and keeps the first 128 columns of o).  The softmax statistics and the
// sums are float32, the output is written in the inputs' type.  The
// reference op repeats each KV head H/KV times before its kernel; this
// kernel reads query head h's KV head g in place instead, which is the
// same function.
//
// Both designs pack the rows of a KV head as its query heads at each
// position, flattened as (position, head in the group): rows f = i * G +
// r of head g * G + r, G = H / KV.  So every K/V tile a block stages
// serves all G query heads that read it (ten at recurrentgemma-2b's
// 10-on-1 GQA, eight at kimi-k2-1t-a32b's 64-on-8), and the rows of a
// block span few positions, so a causal block masks little; the causal
// mask is by row position i = f / G.  A block walks the key axis in
// tiles, with K/V tiles staged in shared memory two stages deep by
// 16-byte `cp.async` copies (the TPU kernel overlaps its copies through
// the BlockSpec pipeline; the stages take that place), and keeps the
// running max, denominator and accumulator in f32 registers across tiles
// (the TPU kernel carries them in VMEM scratch across its sequential
// grid axis).  Causal blocks stop at the tile holding their last row's
// position and are launched longest first; with a window a block starts
// at the tile holding its first row's position - W + 1, and masks per
// element (i - j >= W) beside the causal test, so a window that is not
// a multiple of the key tile is exact.  W = 0 takes no other path than
// before the window existed: the same tiles and the same bits.  The
// launcher picks the design by dtype, in this one library, one launch
// per call:
//
// bfloat16 -> tensor cores (namespace tc).  One block of 4 warps per
// (64-row tile, b * KV + g), 16 rows a warp, 32-key K/V tiles.  S = Q K^T
// by `mma.sync.m16n8k16` (bf16 x bf16 -> f32), Q and K read from shared
// memory by `ldmatrix` (rows padded by 16 bytes, so conflict-free at
// every head dim).  The online softmax runs in f32 on the accumulator
// registers (quad shuffles for the row max); `scale` multiplies the f32
// scores after the product, folded with log2(e) into the exponent's fma
// (exp(scale s - max) = 2^(s scale log2e - max scale log2e), one MUFU
// ex2 each), never into a bf16 q.  P is rounded to bf16 once -- the one
// rounding the plain version does not have; the denominator sums the
// rounded values -- and O += P V by `mma.sync` with P straight from
// registers (S's accumulator layout is the A operand's) and V transposed
// out of shared memory by `ldmatrix.trans`.  o = O / max(l, 1e-30),
// staged through shared memory for 16-byte stores.  At hd <= 128 an SM
// holds four blocks (at most 128 registers a thread), at hd 256 two
// (the 16 x 256 f32 accumulator alone takes 128 registers a thread).
// Bound on an NVIDIA H100 SXM (data-sheet rates, 700 W): at
// kimi-k2-1t-a32b's (B 4, S 512, H 64, KV 8, hd 112) causal shape the
// call reads q, k, v once and writes o once, 66.1 MB (19.7 us at 3.35
// TB/s), and does 15.1 GFLOP of products (15.2 us at 989 TFLOP/s); at
// recurrentgemma-2b's (4, 512, 512, H 10, KV 1, hd 256), 23.1 MB (6.9 us)
// and 5.4 GFLOP (5.4 us): bytes bound both, barely, so the products have
// to run near the tensor rate.  `mma.sync` is Hopper's older tensor-core
// path and this form stays well below that rate (`wgmma` with TMA is the
// faster one: PERF.md says why this form landed and has its measured
// time).
//
// float32 -> CUDA cores (namespace cc), the design of the first port:
// tensor cores cannot meet the f32 tolerance (tf32 keeps 10 mantissa
// bits).  One block of 4 warps per (32-row tile, b * KV + g), 32-key
// tiles.  The block holds its query rows (pre-scaled) in shared memory;
// each warp owns 8 rows, lane j scores key j of the tile against them
// (16-byte loads of K, rows padded by 16 bytes so the 8 lanes of each
// quarter-warp hit distinct banks), the warp reduces the running max and
// denominator with shuffles, and each lane accumulates ceil(hd/32)
// adjacent output columns of its 8 rows from the broadcast probabilities
// (at hd 112 lanes 0-27 own 4 columns each and lanes 28-31 none; at hd 96
// every lane owns 3, loaded and stored one float at a time; at hd 80,
// where 3 does not divide 80, lanes 0-19 own 4 and lanes 20-31 none).  Keys
// past the diagonal and past Skv are masked to probability 0.  Bound: the
// products at the f32 CUDA-core rate, 67 TFLOP/s (80 us for the hd-256
// shape's 5.4 GFLOP).
//
// Optional output, for the backward (flash_attention_bwd.cu): each query
// row's natural-log log-sum-exp of its scaled, masked scores, f32 (B, H,
// Sq), written after the key loop from the running max and denominator
// (flash_attention_lse_launch).  The serving entry,
// flash_attention_window_launch, passes a null pointer: nothing else of
// the kernel changes, so o has the same bits with and without it.  The
// lse entry takes the window (the local layers' training) but not hdv !=
// hd (the backward has no such instance).
//
// Dynamic shared memory, above the 48 KB default at most head dims (the
// launcher raises each instantiation's limit once): tc, 64 query rows and
// 2 stages of 32-key K tiles, (hd + 8) bf16 a row, and V tiles, (hdv +
// 8): 101 376 bytes at hd 256, 46 080 at hd 112, 39 936 at hd 96, 68 608
// at 192/128; cc, 32 hd floats of queries and 2 stages of 32 (hd + 4)
// floats of K and (hdv + 4) of V: 165 888 bytes at hd 256, 63 488 at hd
// 96, 108 544 at 192/128.  At hd 96 the bf16 block walks 6 k-steps of S
// and keeps 12 8-column tiles of o (48 f32 accumulators a thread); a row
// of 104 bf16 is 13 chunks of 16 bytes, odd as at every head dim.  At
// 192/128 the bf16 block keeps 64 f32 accumulators of o a thread (16
// 8-column tiles of the 128 v columns) and walks 12 16-deep k-steps of
// S; one block an SM is asked of the compiler there, as at hd 256.  q, k,
// v and o must start on 16-byte boundaries.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#ifndef CUDA_CPU_MOCK  // tests/test_torch_flash_bwd_cpu.py supplies these
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
#endif

// ---- float32: the CUDA-core design ----------------------------------

namespace cc {

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
// allows (16 bytes when N * sizeof(float) is a multiple of 16).
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

// output columns a lane owns: the fewest (at least ceil(HDV / 32)) that
// divide HDV, so that lanes own whole groups (4 at hd 80: lanes 0-19)
template <int HDV>
__host__ __device__ constexpr int lane_cols() {
  int d = (HDV + 31) / 32;
  while (HDV % d) ++d;
  return d;
}

template <int HD>
__host__ __device__ constexpr int kv_row() {   // padded K/V row, in elements
  return HD + 16 / static_cast<int>(sizeof(float));
}

template <int HD, int HDV>
constexpr int smem_bytes() {
  return kBQ * HD * static_cast<int>(sizeof(float)) +
         kStages * kBK * (kv_row<HD>() + kv_row<HDV>()) *
             static_cast<int>(sizeof(float));
}

// Start copying rows [k0, k0 + kBK) of one (Skv, ., D) matrix (K or V)
// into a stage, rows padded to kv_row<D>().
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int k0, int skv, int64_t stride,
                                           int tid) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(float));  // per 16 bytes
  constexpr int CPR = D / EPC;                          // chunks per row
  constexpr int RS = kv_row<D>();
  static_assert(D % EPC == 0, "whole 16-byte chunks per row");
  constexpr int N = (kBK * CPR + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = tid + i * kThreads;
    if (N * kThreads != kBK * CPR && c >= kBK * CPR) break;
    const int j = c / CPR, col = (c % CPR) * EPC;
    const bool ok = k0 + j < skv;
    cp_async16(dst + j * RS + col, src + (ok ? k0 + j : 0) * stride + col,
               ok);
  }
}

// Start copying keys [k0, k0 + kBK) of K and V into stage st (K's kBK
// rows, then V's).
template <int HD, int HDV>
__device__ __forceinline__ void stage_kv(float* st, const float* kb,
                                         const float* vb, int k0, int skv,
                                         int64_t k_stride, int64_t v_stride,
                                         int tid) {
  stage_rows<HD>(st, kb, k0, skv, k_stride, tid);
  stage_rows<HDV>(st + kBK * kv_row<HD>(), vb, k0, skv, v_stride, tid);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int sq, int skv, int heads,
                       int kv_heads, int causal, int window, float scale) {
  constexpr int KS = kv_row<HD>();
  constexpr int VS = kv_row<HDV>();
  constexpr int STAGE = kBK * (KS + VS);  // floats of one K/V stage
  constexpr int DPL = lane_cols<HDV>();   // output columns per lane
  static_assert(HDV % DPL == 0, "lanes own whole column groups");
  constexpr int QC = 8;                   // query elements per load
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);             // kBQ x HD
  float* kvs = qs + kBQ * HD;  // [stage][K kBK x KS, V kBK x VS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * kRows;           // this warp's first row
  // lanes past HDV / DPL own no column (HDV not a multiple of 32: 80,
  // 112)
  const bool col_ok = lane * DPL < HDV;
  const int group = heads / kv_heads;
  const int rows = sq * group;                   // rows of this KV head
  const int f0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int b = blockIdx.y / kv_heads;
  const int g = blockIdx.y % kv_heads;
  const int64_t pos_stride = static_cast<int64_t>(heads) * HD;
  const int64_t o_pos_stride = static_cast<int64_t>(heads) * HDV;
  const int64_t k_stride = static_cast<int64_t>(kv_heads) * HD;
  const int64_t v_stride = static_cast<int64_t>(kv_heads) * HDV;
  const int64_t head0 = static_cast<int64_t>(b) * sq * heads + g * group;
  const float* kb = k + (static_cast<int64_t>(b) * skv * kv_heads + g) * HD;
  const float* vb = v + (static_cast<int64_t>(b) * skv * kv_heads + g) * HDV;
  // row f (< rows) -> its element offset in q (from head0 * HD) and in o
  // (from head0 * HDV)
  auto row_off = [&](int f) {
    return (f / group) * pos_stride + (f % group) * HD;
  };
  auto o_off = [&](int f) {
    return (f / group) * o_pos_stride + (f % group) * HDV;
  };

  const int last = min(f0 + kBQ, rows) - 1;
  const int kv_end = causal ? min(skv, last / group + 1) : skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  // the window: the first key the block's first row sees, and its tile
  const int t0 = window ? max(0, f0 / group - window + 1) / kBK : 0;
  stage_kv<HD, HDV>(kvs + (t0 % kStages) * STAGE, kb, vb, t0 * kBK, skv,
                    k_stride, v_stride, tid);
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
      load_f32<QC>(q + head0 * HD + row_off(f0 + r) + col, x);
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

  for (int t = t0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {     // the next tile's stage was freed last pass
      stage_kv<HD, HDV>(kvs + ((t + 1) % kStages) * STAGE, kb, vb,
                        (t + 1) * kBK, skv, k_stride, v_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();      // all but the newest group: tile t is in
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kvs + (t % kStages) * STAGE;
    const float* vs = ks + kBK * KS;

    // scores of key t * kBK + lane against this warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float* krow = ks + lane * KS;
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
      const bool ok = kp < skv && (!causal || kp <= qpos[r]) &&
                      (!window || qpos[r] - kp < window);
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
        load_f32<DPL>(vs + j * VS + lane * DPL, vv);
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
    if (lse != nullptr && f < rows && lane == 0) {
      // m and the scores are already scaled (q was): lse = m + ln l
      lse[(static_cast<int64_t>(b) * heads + g * group + f % group) * sq +
          f / group] = m[r] + logf(l[r]);
    }
    if (f < rows && col_ok) {
      const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= inv;
      store_f32<DPL>(o + head0 * HDV + o_off(f) + lane * DPL, acc[r]);
    }
  }
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int sq, int skv, int heads, int kv_heads, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD, HDV>();
  constexpr auto kern = flash_attention_kernel<HD, HDV>;
  static bool attr_set = false;    // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int rows = sq * (heads / kv_heads);
  const dim3 grid((rows + kBQ - 1) / kBQ, batch * kv_heads);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, skv,
      heads, kv_heads, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cc

// ---- bfloat16: the tensor-core design --------------------------------

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;          // query rows per block, 16 a warp
constexpr int kBK = 32;                   // keys per K/V tile
constexpr int kStages = 2;                // K/V tiles in the ring

// The shapes of head dims HD (q, k) and HDV (v, o).
template <int HD, int HDV>
struct Cfg {
  // a shared-memory row of hd elements, padded by 16 bytes: hd / 8 + 1
  // chunks of 16 bytes is odd for every head dim, so the 8 rows that one
  // ldmatrix reads fall on distinct banks (Q and K rows; V rows likewise)
  static constexpr int kRow = HD + 8;
  static constexpr int kRowV = HDV + 8;
  static constexpr int kStage = kBK * (kRow + kRowV);  // elements a stage
  static constexpr int kSmemBytes =
      (kBQ * kRow + kStages * kStage) *
      static_cast<int>(sizeof(__nv_bfloat16));
  // blocks an SM must hold: four at hd <= 128 (at most 128 registers a
  // thread; 52 KB of shared memory at hd 128), one above (hd 256, where
  // the (16 x hd) f32 accumulator alone takes 128 registers a thread;
  // 192/128, whose S walks 12 k-steps)
  static constexpr int kMinBlocks = HD > 128 ? 1 : 4;
};

#ifndef CUDA_CPU_MOCK
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
#endif

// (lo, hi) -> one register of two bf16, lo in the low half, each rounded
// to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}

#ifndef CUDA_CPU_MOCK
// 2^x in one MUFU instruction (results below 2^-126 flush to 0: a
// probability that small is 0 in bf16 P and in the f32 sums alike)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
#endif

// Start copying the kBK rows of one (Skv, ., D) matrix (K or V) from
// src (key k0's row; n_keys = Skv - k0 of them exist) into a stage, rows
// padded to D + 8.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int n_keys, int stride, int tid) {
  constexpr int RS = D + 8, CPR = D / 8;
  constexpr int N = (kBK * CPR + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = tid + i * kThreads;
    if (N * kThreads != kBK * CPR && c >= kBK * CPR) break;
    const int j = c / CPR, col = (c % CPR) * 8;
    const bool ok = j < n_keys;
    const int off = ok ? j * stride + col : 0;      // < 2^31: j < BK
    cp_async16(dst + j * RS + col, src + off, ok);
  }
}

// Start copying key tile t of K and V into its stage (K's kBK rows, then
// V's).
template <int HD, int HDV>
__device__ __forceinline__ void stage_kv(__nv_bfloat16* kvs,
                                         const __nv_bfloat16* kb,
                                         const __nv_bfloat16* vb, int t,
                                         int skv, int k_stride, int v_stride,
                                         int tid) {
  using C = Cfg<HD, HDV>;
  __nv_bfloat16* st = kvs + (t % kStages) * C::kStage;
  const int64_t at = static_cast<int64_t>(t) * kBK;
  stage_rows<HD>(st, kb + at * k_stride, skv - t * kBK, k_stride, tid);
  stage_rows<HDV>(st + kBK * C::kRow, vb + at * v_stride, skv - t * kBK,
                  v_stride, tid);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads, (Cfg<HD, HDV>::kMinBlocks))
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int sq, int skv, int heads, int kv_heads, int causal,
                       int window, float scale) {
  using C = Cfg<HD, HDV>;
  constexpr int BK = kBK, RS = C::kRow, RSV = C::kRowV, CPR = HD / 8;
  constexpr int CPRV = HDV / 8, BQ = kBQ;
  constexpr int NS = BK / 8;              // 8-key column tiles of S
  constexpr int NO = HDV / 8;             // 8-column tiles of O
  static_assert(HD % 16 == 0 && NO % 2 == 0 && HDV <= HD,
                "whole k-steps and pairs; o staged in q's rows");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // BQ x RS
  __nv_bfloat16* kvs = qs + BQ * RS;  // [stage][K BK x RS, V BK x RSV]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = heads / kv_heads;
  const int rows = sq * group;                   // rows of this KV head
  const int f0 = (gridDim.x - 1 - blockIdx.x) * BQ;    // longest first
  const int b = blockIdx.y / kv_heads;
  const int g = blockIdx.y % kv_heads;
  const int64_t pos_stride = static_cast<int64_t>(heads) * HD;
  const int64_t o_pos_stride = static_cast<int64_t>(heads) * HDV;
  const int k_stride = kv_heads * HD;
  const int v_stride = kv_heads * HDV;
  const int64_t head0 = static_cast<int64_t>(b) * sq * heads + g * group;
  const __nv_bfloat16* kb =
      k + (static_cast<int64_t>(b) * skv * kv_heads + g) * HD;
  const __nv_bfloat16* vb =
      v + (static_cast<int64_t>(b) * skv * kv_heads + g) * HDV;
  // row f (< rows) -> its element offset in q (from head0 * HD) and in o
  // (from head0 * HDV)
  auto row_off = [&](int f) {
    return (f / group) * pos_stride + (f % group) * HD;
  };
  auto o_off = [&](int f) {
    return (f / group) * o_pos_stride + (f % group) * HDV;
  };

  const int last = min(f0 + BQ, rows) - 1;
  const int kv_end = causal ? min(skv, last / group + 1) : skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  // the window: the first key the block's first row sees, and its tile
  const int t0 = window ? max(0, f0 / group - window + 1) / BK : 0;

  // the block's query rows (zeros past `rows`) and K/V tile 0: group 0
  static_assert(BQ * CPR % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < BQ * CPR / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = f0 + r < rows;
    cp_async16(qs + r * RS + col,
               q + (ok ? head0 * HD + row_off(f0 + r) : 0) + col, ok);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {  // a group per stage, empty or not
    if (t0 + i < n_tiles) {
      stage_kv<HD, HDV>(kvs, kb, vb, t0 + i, skv, k_stride, v_stride, tid);
    }
    cp_async_commit();
  }

  // this thread's two rows of the warp's 16: fr and fr + 8
  const int wrow = warp * 16;
  const int fr = f0 + wrow + (lane >> 2);
  const int pos[2] = {fr / group, (fr + 8) / group};
  const int warp_pos = (f0 + wrow) / group;      // the warp's first position
  const int warp_end = (f0 + wrow + 15) / group;  // and its last
  const float sl = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};                     // this thread's share
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }

  for (int t = t0; t < n_tiles; ++t) {
    const int next = t + kStages - 1;   // its stage was consumed at t - 1
    if (next < n_tiles) {
      stage_kv<HD, HDV>(kvs, kb, vb, next, skv, k_stride, v_stride, tid);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();       // all but the newest: tile t is in
    __syncthreads();
    const __nv_bfloat16* ks = kvs + (t % kStages) * C::kStage;
    const __nv_bfloat16* vs = ks + BK * RS;

    // S = Q K^T over the tile: 16 rows x BK keys a warp, f32
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + (wrow + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * RS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[j], a, bk[0], bk[1]);
        mma(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // mask keys past Skv, past the diagonal and, with a window, W or more
    // positions back, element by element (the scores stay unscaled:
    // `scale` enters the exponent below, on the f32 scores)
    const int k0 = t * BK;
    if (k0 + BK > skv || (causal && k0 + BK - 1 > warp_pos) ||
        (window && k0 <= warp_end - window)) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= skv || (causal && key > pos[e >> 1]) ||
              (window && pos[e >> 1] - key >= window)) {
            s[j][e] = -INFINITY;
          }
        }
      }
    }

    // online softmax in f32 on the scaled scores: exp(scale s - max) =
    // 2^(s sl - max sl), sl = scale log2(e), with the running max kept
    // unscaled.  P is rounded to bf16 once, and the denominator sums the
    // rounded values, so the weights applied are the weights summed
    uint32_t p[NS][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float base = mx == -INFINITY ? 0.0f : mx * sl;
      const float corr = ex2(fmaf(m[r], sl, -base));
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint32_t pr = pack_bf16(ex2(fmaf(s[j][2 * r], sl, -base)),
                                      ex2(fmaf(s[j][2 * r + 1], sl, -base)));
        const float2 pf = unpack_bf16(pr);
        sum += pf.x + pf.y;
        p[j][r] = pr;
      }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // O += P V: P from registers (S's accumulator layout is the A
    // operand's), V transposed out of shared memory by ldmatrix
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                             p[2 * kk + 1][1]};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + (kk * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * RSV +
                              n * 8 + (lane >> 4) * 8);
        mma(acc[n], a, bv[0], bv[1]);
        mma(acc[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();           // this stage is consumed
  }

  // o = acc / l in bf16, staged through this warp's own query rows (no
  // other warp reads them) so that each row leaves in 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int f = fr + 8 * r;
    if (lse != nullptr && f < rows && (lane & 3) == 0) {
      // the running max is unscaled: lse = max * scale + ln l
      lse[(static_cast<int64_t>(b) * heads + g * group + f % group) * sq +
          f / group] = m[r] * scale + logf(l[r]);
    }
    l[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* orow = qs + (wrow + (lane >> 2)) * RS + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(orow + n * 8) =
        pack_bf16(acc[n][0] * l[0], acc[n][1] * l[0]);
    *reinterpret_cast<uint32_t*>(orow + 8 * RS + n * 8) =
        pack_bf16(acc[n][2] * l[1], acc[n][3] * l[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CPRV; c += 32) {
    const int r = c / CPRV, col = (c % CPRV) * 8;
    const int f = f0 + wrow + r;
    if (f < rows) {
      *reinterpret_cast<uint4*>(o + head0 * HDV + o_off(f) + col) =
          *reinterpret_cast<const uint4*>(qs + (wrow + r) * RS + col);
    }
  }
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int sq, int skv, int heads, int kv_heads, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr int bytes = Cfg<HD, HDV>::kSmemBytes;
  constexpr auto kern = flash_attention_kernel<HD, HDV>;
  static bool attr_set = false;    // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int rows = sq * (heads / kv_heads);
  const dim3 grid((rows + kBQ - 1) / kBQ, batch * kv_heads);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, sq, skv, heads, kv_heads, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The design by dtype: 0 (float32) -> CUDA cores, 1 (bfloat16) -> tensor
// cores.
template <int HD, int HDV>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* o, float* lse, int batch, int sq, int skv, int heads,
                 int kv_heads, int causal, int window, float scale,
                 cudaStream_t s) {
  if (dtype == 0) {
    return cc::launch<HD, HDV>(q, k, v, o, lse, batch, sq, skv, heads,
                               kv_heads, causal, window, scale, s);
  }
  if (dtype == 1) {
    return tc::launch<HD, HDV>(q, k, v, o, lse, batch, sq, skv, heads,
                               kv_heads, causal, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instance of (hd, hdv): hdv = hd at each head dim (stablelm-3b's 80
// and phi-3-vision's 96 among them), and MLA's 192/128.
int launch_hd(int hd, int hdv, int dtype, const void* q, const void* k,
              const void* v, void* o, float* lse, int batch, int sq, int skv,
              int heads, int kv_heads, int causal, int window, float scale,
              cudaStream_t s) {
#define FLASH_CASE(HD, HDV)                                                  \
  if (hd == HD && hdv == HDV) {                                              \
    return launch_dtype<HD, HDV>(dtype, q, k, v, o, lse, batch, sq, skv,     \
                                 heads, kv_heads, causal, window, scale, s); \
  }
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(80, 80)
  FLASH_CASE(96, 96)
  FLASH_CASE(112, 112)
  FLASH_CASE(128, 128)
  FLASH_CASE(256, 256)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_checked(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int sq, int skv, int heads,
                   int kv_heads, int hd, int hdv, int causal, int window,
                   float scale, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || batch * kv_heads > 65535 ||
      static_cast<int64_t>(sq) * (heads / kv_heads) > (1 << 30) ||
      window < 0 || (window > 0 && (!causal || sq > skv)) ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_hd(hd, hdv, dtype, q, k, v, o, lse, batch, sq, skv, heads,
                   kv_heads, causal, window, scale,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  q (batch,
// sq, heads, hd), k (batch, skv, kv_heads, hd), v (batch, skv, kv_heads,
// hdv) and o (batch, sq, heads, hdv), row-major; (hd, hdv) one of (32,
// 32), (64, 64), (80, 80), (96, 96), (112, 112), (128, 128), (256, 256),
// (192, 128);
// heads a multiple of kv_heads; every pointer on a 16-byte boundary.  Sq
// and Skv are free (whisper's cross-attention: 128 queries, 1 500 keys,
// non-causal).  window 0
// masks nothing more; window > 0 needs causal and sq <= skv (so that a
// query row always sees its own key) and hides key j from query i when
// i - j >= window.
extern "C" int flash_attention_window_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int sq,
    int skv, int heads, int kv_heads, int hd, int hdv, int causal, int window,
    float scale, int dtype, void* stream) {
  return launch_checked(q, k, v, o, nullptr, batch, sq, skv, heads, kv_heads,
                        hd, hdv, causal, window, scale, dtype, stream);
}

// hdv = hd; window as flash_attention_window_launch's.  lse, when not
// null, is float32 (batch, heads, sq): each query row's natural-log
// log-sum-exp of its scaled, masked scores, which the backward
// (flash_attention_bwd.cu) recomputes P from; a null lse is written
// nowhere and changes nothing else.
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int batch, int sq, int skv,
                                          int heads, int kv_heads, int hd,
                                          int causal, int window, float scale,
                                          int dtype, void* stream) {
  return launch_checked(q, k, v, o, lse, batch, sq, skv, heads, kv_heads, hd,
                        hd, causal, window, scale, dtype, stream);
}
