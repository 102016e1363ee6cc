// rwkv6_wkv.cu — the RWKV-6 WKV recurrence, for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_wkv/kernel.py::
// _kernel (launched by wkv_chunked_kernel; the port's rwkv layers reach
// this one through repro_torch.models.rwkv6::time_mix_apply, one launch
// per layer per prefill).  It computes the same function as
// src/repro_torch/kernels/rwkv6_wkv/ref.py::wkv_ref, per (batch b, head
// h), with S an (hd, hd) float32 state starting at zero:
//
//   out[t, j] = sum_i r[t, i] * (S[i, j] + u[i] * k[t, i] * v[t, j])
//   S[i, j]   = w[t, i] * S[i, j] + k[t, i] * v[t, j]
//
// and also writes the final S, which the model hands to decode.  r, k,
// v, w are float32 in the model's (B, T, H, hd) layout, read through the
// strides of their batch, time and head axes (unit stride along hd; no
// transpose); u is (H, hd); out is written (B, T, H, hd), S (B, H, hd,
// hd), both contiguous float32.
//
// The recurrence is exact: no chunked factorisation.  The TPU kernel
// takes a T-chunk at a time as masked (C x C) products with the decay
// factored as exp(max(L_prev, -30)) * exp(min(-L, 30)); once a chunk's
// accumulated log decay passes 30 that product is no longer the decay,
// and its output is wrong at its own default chunk of 64 for realistic
// decays.  Here each step applies w[t] to the state itself, so nothing
// is factored and nothing is clamped.
//
// Design.  Each value column S[:, j] evolves on its own, so one block
// per (b, h) holds the whole state in registers and walks t in order: a
// thread owns 4 rows by 8 columns (rows 4g..4g+3, columns 8c..8c+7).
// The rows of r, k, w and v for 16 steps are staged in shared memory,
// four stages deep, by 16-byte cp.async: three chunks are in flight
// while the block computes on the fourth.  The sum over i of a step is split as sum_i r_i S_ij +
// v_j * sum_i r_i u_i k_i: in the walk each thread only writes its rows'
// part of the first term to a shared-memory row and advances its rows
// of S, with no exchange between threads, and reads the next step's
// operands while it computes; once per chunk the block computes each
// step's bonus (the second sum) and adds the row groups' parts up,
// writing 16 whole rows of out.  Sums run in another order than the
// plain version's, so results agree to a tolerance (tests/
// test_kernels.py's 2e-3 as the ceiling), not bit for bit.
//
// Bound on an NVIDIA H100 SXM (data-sheet rates, 700 W power limit):
// bytes.  The function must read r, k, v, w once (16*B*T*H*hd bytes)
// and u, and write out (4*B*T*H*hd) and S (4*B*H*hd*hd).  At the serve
// path's (B 4, T 512, H 32, hd 64) that is 86.0 MB, 25.7 us at
// 3.35 TB/s; its 5*hd^2 + 4*hd flops per (b, h, t) (1.36 GFLOP) take
// 20.3 us at the 67 TFLOP/s f32 CUDA-core rate.  This simple form is
// further from either: each step's operands are read from shared memory
// by every thread that needs them, and the (b, h) pairs give only one
// block per SM, so shared-memory bandwidth (~28 wavefronts per warp per
// step, 4 warps) and the 96 FP instructions per warp per step of the
// walk bound it.  Owning 4 x 8 of the state, not 8 x 2, cuts those reads
// about 2x against a first version (PERF.md has the measured times).
// The chunked form on tensor cores is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // time steps per shared-memory stage
constexpr int kStages = 4;  // stages in flight: three chunks read ahead
constexpr int kRows = 4;    // state rows a thread owns (one float4 of i)
constexpr int kCols = 8;    // value columns a thread owns (two float4 of j)

template <int HD>
struct Tile {
  static constexpr int kGroups = HD / kRows;               // row groups
  static constexpr int kThreads = (HD / kCols) * kGroups;  // HD * HD / 32
  static constexpr int kArray = kChunk * HD;               // floats of one array
  static constexpr int kStage = 4 * kArray;                // r, k, w, v
  static constexpr int kPartRow = HD + 4;                  // padded partial row
  static constexpr int kPart = kChunk * kGroups * kPartRow;
  // the stages, the partial sums, the bonus of each step
  static constexpr int kSmemFloats = kStages * kStage + kPart + kChunk;
  static constexpr int kVec = HD / 4;                      // float4s of a row
  static constexpr int kRowsPerPass = kThreads / kVec;     // staging rows
  static constexpr unsigned kMask =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1u;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// Stage steps [t0, t0 + kChunk) of r, k, w, v for one (b, h) into `dst`
// (four (kChunk, HD) arrays): this thread copies float4 column `cc` of
// rows tr, tr + kRowsPerPass, ...; rows past t_len are left unwritten.
template <int HD>
__device__ __forceinline__ void stage_rows(
    float* dst, const float* r, const float* k, const float* w,
    const float* v, int64_t t0, int64_t t_len, int64_t st, int tr, int cc) {
  using S = Tile<HD>;
#pragma unroll
  for (int n = 0; n < kChunk / S::kRowsPerPass; ++n) {
    const int t = tr + n * S::kRowsPerPass;
    if (t0 + t < t_len) {
      const int64_t off = (t0 + t) * st + 4 * cc;
      float* d = dst + t * HD + 4 * cc;
      cp_async16(d, r + off);
      cp_async16(d + S::kArray, k + off);
      cp_async16(d + 2 * S::kArray, w + off);
      cp_async16(d + 3 * S::kArray, v + off);
    }
  }
}

// What one thread reads of one step: its rows of r, k, w and its
// columns of v.
struct StepIn {
  float4 r, k, w, v[kCols / 4];
};

template <int HD>
__device__ __forceinline__ StepIn load_step(const float* stage, int t, int g,
                                            int c) {
  using S = Tile<HD>;
  StepIn in;
  in.r = reinterpret_cast<const float4*>(stage + t * HD)[g];
  in.k = reinterpret_cast<const float4*>(stage + S::kArray + t * HD)[g];
  in.w = reinterpret_cast<const float4*>(stage + 2 * S::kArray + t * HD)[g];
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q)
    in.v[q] = reinterpret_cast<const float4*>(
        stage + 3 * S::kArray + t * HD)[(kCols / 4) * c + q];
  return in;
}

// One step of the thread's share of the recurrence: sum_i r_i S_ij over
// its rows for its columns, into the step's partial row, then its rows
// of S advanced by w and k v^T.
template <int HD>
__device__ __forceinline__ void step_rows(const StepIn& in, float* part_row,
                                          float (&s)[kRows][kCols]) {
  float vj[kCols];
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) vj[4 * q + e] = lane(in.v[q], e);
  }
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float ri = lane(in.r, i), ki = lane(in.k, i), wi = lane(in.w, i);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      acc[j] = fmaf(ri, s[i][j], acc[j]);
      s[i][j] = fmaf(wi, s[i][j], ki * vj[j]);
    }
  }
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q)
    reinterpret_cast<float4*>(part_row)[q] =
        make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                    acc[4 * q + 3]);
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads)
rwkv6_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ out,
                 float* __restrict__ state, int64_t t_len, int heads,
                 int64_t sb, int64_t st, int64_t sh) {
  using S = Tile<HD>;
  constexpr int G = S::kGroups;
  constexpr int Q = HD / 4;                       // float4s of one row
  extern __shared__ __align__(16) float smem[];
  float* part = smem + kStages * S::kStage;
  float* bonus = part + S::kPart;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int g = tid % G;                          // rows 4g..4g+3
  const int c = tid / G;                          // columns 8c..8c+7
  const int q = tid % Q;                          // bonus pass: rows 4q..4q+3
  const int64_t in_off = b * sb + h * sh;
  const float* rb = r + in_off;
  const float* kb = k + in_off;
  const float* wb = w + in_off;
  const float* vb = v + in_off;
  const int tr = tid / S::kVec;                   // staging row, column
  const int cc = tid % S::kVec;
  const float4 u4 = reinterpret_cast<const float4*>(u + h * HD)[q];
  float* part_g = part + g * S::kPartRow + kCols * c;

  float s[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
  }

  // one commit group per chunk (empty past the end), kStages - 1 ahead
  const int64_t n_chunks = (t_len + kChunk - 1) / kChunk;
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < n_chunks)
      stage_rows<HD>(smem + n * S::kStage, rb, kb, wb, vb, n * kChunk, t_len,
                     st, tr, cc);
    cp_async_commit();
  }
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    const int64_t ahead = ch + kStages - 1;    // into the stage ch - 1 used
    if (ahead < n_chunks)
      stage_rows<HD>(smem + (ahead % kStages) * S::kStage, rb, kb, wb, vb,
                     ahead * kChunk, t_len, st, tr, cc);
    cp_async_commit();
    cp_async_wait<kStages - 1>();               // chunk ch has landed
    __syncthreads();
    const float* stage = smem + (ch % kStages) * S::kStage;
    const int64_t t0 = ch * kChunk;
    const int steps = static_cast<int>(
        t_len - t0 < kChunk ? t_len - t0 : kChunk);

    // the bonus of each step, sum_i r_i u_i k_i: Q lanes per step
    for (int base = 0; base < kChunk * Q; base += S::kThreads) {
      const int t = (base + tid) / Q;
      float p = 0.0f;
      if (t < steps) {
        const float4 r4 = reinterpret_cast<const float4*>(stage + t * HD)[q];
        const float4 k4 = reinterpret_cast<const float4*>(
            stage + S::kArray + t * HD)[q];
        p = r4.x * u4.x * k4.x + r4.y * u4.y * k4.y + r4.z * u4.z * k4.z
            + r4.w * u4.w * k4.w;
      }
#pragma unroll
      for (int off = Q / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(S::kMask, p, off);
      if (q == 0 && t < steps) bonus[t] = p;
    }

    // the walk; each step's operands are read while the one before
    // computes (row kChunk - 1 stands in past the end: read, unused)
    StepIn cur = load_step<HD>(stage, 0, g, c);
    if (steps == kChunk) {
#pragma unroll 4
      for (int t = 0; t < kChunk; ++t) {
        const StepIn nxt = load_step<HD>(
            stage, t + 1 < kChunk ? t + 1 : kChunk - 1, g, c);
        step_rows<HD>(cur, part_g + t * G * S::kPartRow, s);
        cur = nxt;
      }
    } else {
#pragma unroll 1
      for (int t = 0; t < steps; ++t) {
        const StepIn nxt = load_step<HD>(
            stage, t + 1 < kChunk ? t + 1 : kChunk - 1, g, c);
        step_rows<HD>(cur, part_g + t * G * S::kPartRow, s);
        cur = nxt;
      }
    }
    __syncthreads();

    // out[t, j] = sum over row groups of the partials + v[t, j] * bonus,
    // four columns a thread at a time
#pragma unroll
    for (int n = 0; n < kChunk * S::kVec / S::kThreads; ++n) {
      const int idx = tid + n * S::kThreads;
      const int t = idx / S::kVec;
      const int j = 4 * (idx - t * S::kVec);
      if (t < steps) {
        float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const float4 p = *reinterpret_cast<const float4*>(
              part + (t * G + gg) * S::kPartRow + j);
          sum.x += p.x;
          sum.y += p.y;
          sum.z += p.z;
          sum.w += p.w;
        }
        const float4 vj = *reinterpret_cast<const float4*>(
            stage + 3 * S::kArray + t * HD + j);
        const float bt = bonus[t];
        *reinterpret_cast<float4*>(
            out + ((b * t_len + t0 + t) * heads + h) * HD + j) =
            make_float4(fmaf(vj.x, bt, sum.x), fmaf(vj.y, bt, sum.y),
                        fmaf(vj.z, bt, sum.z), fmaf(vj.w, bt, sum.w));
      }
    }
    __syncthreads();   // the stage and the partials are refilled next
  }

  float* s_out = state + static_cast<int64_t>(bh) * HD * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int q4 = 0; q4 < kCols / 4; ++q4)
      reinterpret_cast<float4*>(s_out + (kRows * g + i) * HD + kCols * c)[q4] =
          make_float4(s[i][4 * q4], s[i][4 * q4 + 1], s[i][4 * q4 + 2],
                      s[i][4 * q4 + 3]);
  }
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* out, float* state, long long batch,
           long long t_len, int heads, long long sb, long long st,
           long long sh, cudaStream_t stream) {
  using S = Tile<HD>;
  const long long blocks = batch * heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = S::kSmemFloats * static_cast<int>(sizeof(float));
  static bool attr_set = false;    // per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_wkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  rwkv6_wkv_kernel<HD><<<static_cast<unsigned>(blocks), S::kThreads, bytes,
                         stream>>>(r, k, v, w, u, out, state, t_len, heads,
                                   sb, st, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w: (batch, t_len, heads, hd) float32 with element strides sb,
// st, sh of their batch, time and head axes (the same for all four; unit
// stride along hd; every stride a multiple of 4 and every pointer on a
// 16-byte boundary); u: (heads, hd); out: (batch, t_len, heads, hd) and
// state: (batch, heads, hd, hd), contiguous.  hd is 16, 32 or 64.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u, void* out,
                                void* state, long long batch,
                                long long t_len, int heads, int hd,
                                long long sb, long long st, long long sh,
                                void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  auto* of = static_cast<float*>(out);
  auto* sf = static_cast<float*>(state);
  auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(rf, kf, vf, wf, uf, of, sf, batch, t_len, heads, sb,
                        st, sh, s);
    case 32:
      return launch<32>(rf, kf, vf, wf, uf, of, sf, batch, t_len, heads, sb,
                        st, sh, s);
    case 64:
      return launch<64>(rf, kf, vf, wf, uf, of, sf, batch, t_len, heads, sb,
                        st, sh, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
