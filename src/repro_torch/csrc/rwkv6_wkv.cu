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
// hd), both contiguous float32.  hd is 16, 32 or 64; any T >= 1.
//
// Design: the recurrence in steps of 16 time steps (a sub-tile, rows m
// .. m + 15), each a step in matrix form whose products run on tensor
// cores:
//
//   out[m:m+16] = [r~ | A] @ [S; V]         S = diag(P) S + k~^T V
//
// with r~_t = r_t * prod_{m <= tau < t} w_tau, k~_s = k_s * prod_{s < tau
// <= m+15} w_tau, P = prod_{m <= tau <= m+15} w_tau, and A the sub-tile's
// 16 x 16 lower triangle taken exactly, elementwise in f32:
// A[t, s] = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i] (s < t) and
// A[t, t] = sum_i r_t[i] u[i] k_t[i] (the bonus).  The decays enter only
// as running products of w in (0, 1], so no factor exceeds 1 and nothing
// is clamped: a product that underflows to 0 stands for a value below
// 1e-38.  The TPU kernel factors its chunk's decay as exp(max(L_prev,
// -30)) * exp(min(-L, 30)) instead, which stops being the decay once a
// chunk's log decay passes 30 (ROADMAP C; at chip_smoke's N(1, 1) decays
// one step's log decay can pass -50).
//
// Layout.  One block of two warpgroups per (b, h).  Chunks of 64 steps
// of r, w, k, v stream into shared memory by TMA (four 4-D boxes of hd x
// 64 a chunk, one thread issues them, they complete on the stage's
// mbarrier), two stages: chunk c + 1 lands while chunk c computes; rows
// past T arrive as 0 and w's are then set to 1, which changes neither out
// nor S.  Per chunk, all eight warps prepare its four sub-tiles on the
// CUDA cores: A exactly (a lane sums hd / 8 channels of one sub-tile for
// columns s and 15 - s with a running product over t; the channel groups'
// partial sums are added after), then r~, k~, P (a thread per (sub-tile,
// channel)), and they write the tensor cores' operands as tf32 hi and lo
// in wgmma's K-major tiles without swizzle: r~^T (its tiles padded so
// that a warp writing one row t hits 32 banks), k~, v^T and A^T.  Then
// warpgroup 0 walks the sub-tiles on the tensor cores, with S^T (rows j,
// columns i) in its accumulators for the whole walk:
//
//   out^T (64 x 16) = S^T r~^T + v^T A^T      wgmma m64n16k8, S^T as the
//                                             register A operand
//   S^T (64 x hd)   = S^T diag(P) + v^T k~    wgmma m64n{hd}k8
//
// S^T's register operand is built from the accumulators by quad
// shuffles, so the state never goes through shared memory.  At hd < 64
// the rows j >= hd of S^T and v^T are 0.  One TF32 pass keeps 11 bits of
// each operand and misses tests/test_kernels.py's 2e-3 on these sums at
// every decay chip_smoke draws, where 3xTF32 stays under 1 % of it
// (tests/test_torch_recurrence_numerics.py emulates both), so every
// product is 3xTF32: hi = x rounded to tf32 as cvt.rna.tf32 rounds
// it, lo = x - hi cut to tf32 (integer ops: cvt runs at a fraction of the
// rate), lo*hi + hi*lo and hi*hi into separate accumulators, for out by
// the parity of the k-step too, so that no chain of dependent wgmmas is
// long.  Sums run in another order than the plain version's, so results
// agree to a tolerance (2e-3), not bit for bit.  The value columns of one
// (b, h) could be split over two blocks; the serve shape's (b, h) pairs
// already give 128 blocks, and the split is not taken (not measured).
//
// Bound on an NVIDIA H100 SXM (data-sheet rates, 700 W power limit):
// bytes.  The function must read r, k, v, w once (16*B*T*H*hd bytes)
// and u, and write out (4*B*T*H*hd) and S (4*B*H*hd*hd).  At the serve
// path's (B 4, T 512, H 32, hd 64) that is 86.0 MB, 25.7 us at
// 3.35 TB/s; the exact recurrence's 5*hd^2 + 4*hd flops per (b, h, t)
// (1.36 GFLOP) take 20.3 us at the 67 TFLOP/s f32 CUDA-core rate, and
// this form's 3 x 2 x 64 x 16 x (hd + 16 + hd) tensor-core flops per
// sub-tile (3.6 GFLOP) 7.3 us at the 495 TFLOP/s TF32 rate.  The kernel
// runs its phases one after another, so the chunk's CUDA-core work and
// the walk's chain of dependent sub-tiles add up (PERF.md has the
// measured time).

#include <cstdint>
#include <cuda_runtime.h>
#ifndef CUDA_CPU_MOCK
#include <cuda.h>
#include <cudaTypedefs.h>
#endif

namespace {

constexpr int kSub = 16;     // steps per sub-tile: one matrix step
constexpr int kSubs = 4;     // sub-tiles per staged chunk
constexpr int kChunk = kSub * kSubs;
constexpr int kThreads = 256;  // warpgroup 0 runs the products, all prepare

// A tf32 wgmma operand tile in shared memory, K-major without swizzle:
// element (row, k) of a (rows x 8) tile at byte (row / 8) * 256 + (k / 4)
// * 128 + (row % 8) * 16 + (k % 4) * 4, i.e. 8 x 4 core matrices, the two
// along k 128 bytes apart (LBO), row groups 256 bytes apart (SBO).
__device__ __forceinline__ int core_at(int row, int k) {
  return (row / 8) * 64 + (k / 4) * 32 + (row % 8) * 4 + (k % 4);  // floats
}

// r~^T's tiles (16 rows t, k = i) are written a row t at a time by 32
// lanes of consecutive i, so they are padded: LBO 144 bytes, SBO 288,
// tiles kPadTile floats apart, which puts those 32 floats in 32 banks
constexpr int kPadTile = 168;
__device__ __forceinline__ int core_pad(int row, int k) {
  return (row / 8) * 72 + (k / 4) * 36 + (row % 8) * 4 + (k % 4);  // floats
}

template <int HD>
struct Tile {
  static constexpr int kCpl = HD / 8;             // channels a lane sums for A
  static constexpr int kKk = HD / 8;              // k-steps over i
  static constexpr int kArray = kChunk * HD;      // one staged array
  static constexpr int kStage = 4 * kArray;       // r, w, k, v
  // A's partial sums, by (sub-tile, t, s, lane's channel group): 8 groups
  static constexpr int kPartQ = kSub * kSub * 8 + 8;
  static constexpr int kPart = kSubs * kPartQ;
  // operand tiles (floats) per sub-tile and k-step: k~ (hd rows i) and
  // r~^T's hi (16 rows t) over the chunk's stage, r~^T's lo and A^T (16
  // rows t) of their own, v^T (64 rows j) over the partial sums
  static constexpr int kRt = kSubs * kKk * kPadTile;  // r~^T hi (and lo)
  static constexpr int kKt = kSubs * 2 * HD * 8;  // k~ hi, then lo
  static constexpr int kVt = kSubs * 2 * 512;     // v^T hi, then lo
  static constexpr int kAt = kSubs * 2 * 128;     // A^T hi, then lo
  static constexpr int kP = kSubs * HD;           // P of each sub-tile
  static constexpr int kSmemFloats = 2 * kStage + kPart + 2 * kAt + kP + kRt;
  static_assert(kRt + 2 * kKt <= kStage, "r~^T's hi and k~ fit the stage");
  static_assert(2 * kVt <= kPart, "v^T fits the partial sums");
};

#ifndef CUDA_CPU_MOCK  // tests/test_torch_recurrence_kernels_cpu.py supplies these
using TensorMap = CUtensorMap;

// The TMA map of one (batch, t_len, heads, hd) float32 array with element
// strides sb, st, sh (unit along hd): boxes of hd x 1 x kChunk x 1, rows
// past t_len read as 0.  Host code; 0 or a CUresult.
int make_map(TensorMap* map, const float* base, int hd, long long heads,
             long long t_len, long long batch, long long sh, long long st,
             long long sb) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess
        || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(CUDA_ERROR_NOT_FOUND);
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  // an axis of size 1 is never stepped along; give it a stride TMA takes
  if (heads == 1) sh = hd;
  if (t_len == 1) st = heads * sh;
  if (batch == 1) sb = t_len * st;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(st) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd), 1, kChunk, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// one (hd x kChunk) box of the map at (0, h, t, b) into dst (128-byte
// aligned), completing on bar
__device__ __forceinline__ void tma_load(float* dst, const TensorMap* map,
                                         int h, int t, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(bar)), "r"(0), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// this thread's shared-memory writes ordered before the tensor cores'
// reads (wgmma reads through the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a wgmma descriptor of the tile at p (16-byte aligned): no swizzle,
// core matrices lbo bytes apart along k and sbo bytes apart along rows
__device__ __forceinline__ uint64_t desc(const float* p, int lbo = 128,
                                         int sbo = 256) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// keeps the compiler from moving uses of wgmma registers across the
// asynchronous wgmmas that read or write them
template <int N>
__device__ __forceinline__ void reg_fence(float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(x[e])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+r"(x[e])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= a b over warpgroup 0: a (64 x 8) and b (N x 8) tf32 tiles in
// shared memory, d (64 x N) f32 in registers; d = a b when add is 0
__device__ __forceinline__ void wgmma16(float (&d)[8], uint64_t a, uint64_t b,
                                        int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(add));
}

// the same with a (64 x 8) in registers, a0..a3 as mma.sync's m16n8k8
// A fragment in each warp's 16 rows
__device__ __forceinline__ void wgmma16(float (&d)[8], const uint32_t (&a)[4],
                                        uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

__device__ __forceinline__ void wgmma_n(float (&d)[8], uint64_t a,
                                        uint64_t b) {
  wgmma16(d, a, b, 1);
}

__device__ __forceinline__ void wgmma_n(float (&d)[16], uint64_t a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n(float (&d)[32], uint64_t a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
#endif

// x as tf32 hi and lo for 3xTF32: hi = x rounded to nearest (ties away)
// at 10 mantissa bits, as cvt.rna.tf32.f32 rounds it, lo = x - hi (exact
// in f32) cut to tf32; hi + lo carries 21 of x's 24 mantissa bits.
// Integer ops, at the full rate (cvt runs at a fraction of it).
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = __uint_as_float(h);
  lo = __uint_as_float(__float_as_uint(x - hi) & 0xffffe000u);
}

// The C = hd / 8 channels lane gg of a group of 8 sums for A: float4s
// at 4 gg, 32 + 4 gg, ... (float2s at 2 gg when C is 2), so 8 lanes read
// 128 contiguous bytes at a time.
template <int C>
__device__ __forceinline__ void load_lane(float (&x)[C], const float* row,
                                          int gg) {
  if constexpr (C == 2) {
    const float2 f = reinterpret_cast<const float2*>(row)[gg];
    x[0] = f.x;
    x[1] = f.y;
  } else {
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      const float4 f = reinterpret_cast<const float4*>(row + 32 * j)[gg];
      x[4 * j] = f.x;
      x[4 * j + 1] = f.y;
      x[4 * j + 2] = f.z;
      x[4 * j + 3] = f.w;
    }
  }
}

// Stage steps [t0, t0 + kChunk) of r, w, k, v into `stage` (dense rows;
// rows past t_len are 0) by four TMA boxes completing on bar; one thread.
template <int HD>
__device__ __forceinline__ void stage_chunk(float* stage, uint64_t* bar,
                                            const TensorMap* maps, int h,
                                            int t0, int b) {
  using S = Tile<HD>;
  mbar_expect(bar, static_cast<uint32_t>(4 * S::kArray * sizeof(float)));
#pragma unroll
  for (int a = 0; a < 4; ++a)
    tma_load(stage + a * S::kArray, maps + a, h, t0, b, bar);
}

// The four maps as one kernel parameter, in .param space
struct Maps {
  TensorMap m[4];   // r, w, k, v
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_wkv_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ u, float* __restrict__ out,
                 float* __restrict__ state, int64_t t_len, int heads) {
  using S = Tile<HD>;
  constexpr int C = S::kCpl;
  extern __shared__ __align__(128) float smem[];
  float* part = smem + 2 * S::kStage;
  float* at_buf = part + S::kPart;                // A^T hi, lo
  float* p_buf = at_buf + 2 * S::kAt;
  float* rt_lo = p_buf + S::kP;                   // r~^T lo
  float* vt_buf = part;                           // v^T hi, lo

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;         // accumulator coordinates
  const bool wg0 = warp < 4;
  __shared__ uint64_t bars[2];                    // a stage's TMA boxes

  // S^T (rows j, columns i), warpgroup 0's accumulators: rows 16 warp + g
  // (+ 8), columns 8 n + 2 t4 (+ 1)
  float s_acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) s_acc[e] = 0.0f;

  const int64_t n_chunks = (t_len + kChunk - 1) / kChunk;
  const int stager = 128;                         // warpgroup 1's first
  if (tid == stager) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    stage_chunk<HD>(smem, &bars[0], maps.m, h, 0, b);
  }
  __syncthreads();                                // the barriers are set
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    const int64_t t0 = ch * kChunk;
    float* stage = smem + (ch & 1) * S::kStage;
    float* sr = stage;
    float* sw = stage + S::kArray;
    float* sk = stage + 2 * S::kArray;
    float* sv = stage + 3 * S::kArray;
    const int steps = static_cast<int>(
        t_len - t0 < kChunk ? t_len - t0 : kChunk);
    mbar_wait(&bars[ch & 1], (ch >> 1) & 1);       // chunk ch has landed
    for (int e = tid; e < (kChunk - steps) * HD; e += kThreads)
      sw[steps * HD + e] = 1.0f;                  // past T: no effect
    __syncthreads();
    // the next chunk streams into the other stage (free since the barrier
    // that ended chunk ch - 1) while this one computes
    if (tid == stager && ch + 1 < n_chunks)
      stage_chunk<HD>(smem + ((ch + 1) & 1) * S::kStage,
                      &bars[(ch + 1) & 1], maps.m, h,
                      static_cast<int>(t0 + kChunk), b);

    // A's partial sums, exactly: lane (q, gg) of a warp sums hd / 8
    // channels (load_lane) of sub-tile q for the warp's columns s0 and
    // s1 = 15 - s0 together (every warp walks 15 steps), over t with kap
    // = k_s * prod_{s < tau < t} w_tau; the diagonal holds the bonus r_s
    // . (u * k_s)
    {
      const int q = lane / 8, gg = lane % 8;
      const float* rq = sr + q * kSub * HD;
      const float* wq = sw + q * kSub * HD;
      float* pq = part + q * S::kPartQ + gg;
      float uu[C];
      load_lane(uu, u + h * HD, gg);
      const int s0 = warp, s1 = kSub - 1 - warp;
      float kap0[C], kap1[C], rs[C];
      load_lane(kap0, sk + (q * kSub + s0) * HD, gg);
      load_lane(kap1, sk + (q * kSub + s1) * HD, gg);
      load_lane(rs, rq + s0 * HD, gg);
      float dg0 = 0.0f, dg1 = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) dg0 = fmaf(rs[c], uu[c] * kap0[c], dg0);
      load_lane(rs, rq + s1 * HD, gg);
#pragma unroll
      for (int c = 0; c < C; ++c) dg1 = fmaf(rs[c], uu[c] * kap1[c], dg1);
      float dot0[kSub], dot1[kSub];               // A[t, s] for t > s
#pragma unroll
      for (int t = 1; t < kSub; ++t) {
        dot0[t] = dot1[t] = 0.0f;
        if (t > s0) {                             // s0 is the same warp-wide
          float rt[C], wt[C];
          load_lane(rt, rq + t * HD, gg);
          load_lane(wt, wq + t * HD, gg);
          float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) d0 = fmaf(rt[c], kap0[c], d0);
          dot0[t] = d0;
#pragma unroll
          for (int c = 0; c < C; ++c) kap0[c] *= wt[c];
          if (t > s1) {
#pragma unroll
            for (int c = 0; c < C; ++c) d1 = fmaf(rt[c], kap1[c], d1);
            dot1[t] = d1;
#pragma unroll
            for (int c = 0; c < C; ++c) kap1[c] *= wt[c];
          }
        }
      }
      pq[(s0 * kSub + s0) * 8] = dg0;
      pq[(s1 * kSub + s1) * 8] = dg1;
#pragma unroll
      for (int t = 1; t < kSub; ++t) {
        if (t > s0) pq[(t * kSub + s0) * 8] = dot0[t];
        if (t > s1) pq[(t * kSub + s1) * 8] = dot1[t];
      }
    }
    __syncthreads();

    // A = the partials summed over the channel groups, 0 above the
    // diagonal, into A^T's tiles (rows t, k = s) as tf32 hi and lo
    for (int e = tid; e < kSubs * kSub * kSub; e += kThreads) {
      const int q = e / (kSub * kSub), ts = e % (kSub * kSub);
      const int t = ts / kSub, s = ts % kSub;
      float sum = 0.0f;
      if (s <= t) {
        const float4* pp = reinterpret_cast<const float4*>(
            part + q * S::kPartQ + ts * 8);
        const float4 x0 = pp[0], x1 = pp[1];
        sum = ((x0.x + x0.y) + (x0.z + x0.w)) + ((x1.x + x1.y) + (x1.z + x1.w));
      }
      const int at = (q * 2 + s / 8) * 128 + core_at(t, s % 8);
      split(sum, at_buf[at], at_buf[S::kAt + at]);
    }
    // then r~, k~, v and P: thread (q, channel i) takes its column of the
    // sub-tile, and once every thread holds its own, writes r~^T (rows t,
    // k = i) and k~ (rows i, k = s) over the stage and v^T (rows j = i, k
    // = s; rows j >= hd stay 0) over the partial sums, as tf32 hi and lo
    constexpr int kCols = kSubs * HD;             // (q, i) columns
    constexpr int kMine = (kCols + kThreads - 1) / kThreads;
    float rv[kMine][kSub], wv[kMine][kSub], kv[kMine][kSub], vv[kMine][kSub];
#pragma unroll
    for (int n = 0; n < kMine; ++n) {
      const int col = tid + n * kThreads;
      if (col < kCols) {
        const int q = col / HD, i = col % HD;
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
          const int at = (q * kSub + t) * HD + i;
          rv[n][t] = sr[at];
          wv[n][t] = sw[at];
          kv[n][t] = sk[at];
          vv[n][t] = sv[at];
        }
      }
    }
    __syncthreads();
    if constexpr (HD < 64) {                      // v^T's rows j >= hd
      constexpr int kPad = (64 - HD) * 8;         // per tile
      for (int e = tid; e < kSubs * 2 * kPad; e += kThreads) {
        const int tile = e / kPad, x = e % kPad;
        const int at = tile * 512 + core_at(HD + x / 8, x % 8);
        vt_buf[at] = 0.0f;
        vt_buf[S::kVt + at] = 0.0f;
      }
    }
    float* kt_buf = stage;                        // k~ hi, lo
    float* rt_buf = stage + 2 * S::kKt;           // r~^T hi
#pragma unroll
    for (int n = 0; n < kMine; ++n) {
      const int col = tid + n * kThreads;
      if (col >= kCols) continue;
      const int q = col / HD, i = col % HD;
      float p = 1.0f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const int at = (q * S::kKk + i / 8) * kPadTile + core_pad(t, i % 8);
        split(rv[n][t] * p, rt_buf[at], rt_lo[at]);
        p *= wv[n][t];
      }
      p_buf[q * HD + i] = p;
      float e = 1.0f;
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t) {
        kv[n][t] *= e;
        e *= wv[n][t];
      }
      // v^T and k~ have this thread's channel as their row: four steps
      // (a core row, 16 bytes) at a time
#pragma unroll
      for (int t = 0; t < kSub; t += 4) {
        float4 vh, vl, kh, kl;
        split(vv[n][t], vh.x, vl.x);
        split(vv[n][t + 1], vh.y, vl.y);
        split(vv[n][t + 2], vh.z, vl.z);
        split(vv[n][t + 3], vh.w, vl.w);
        split(kv[n][t], kh.x, kl.x);
        split(kv[n][t + 1], kh.y, kl.y);
        split(kv[n][t + 2], kh.z, kl.z);
        split(kv[n][t + 3], kh.w, kl.w);
        const int av = (q * 2 + t / 8) * 512 + core_at(i, t % 8);
        const int ak = (q * 2 + t / 8) * HD * 8 + core_at(i, t % 8);
        *reinterpret_cast<float4*>(vt_buf + av) = vh;
        *reinterpret_cast<float4*>(vt_buf + S::kVt + av) = vl;
        *reinterpret_cast<float4*>(kt_buf + ak) = kh;
        *reinterpret_cast<float4*>(kt_buf + S::kKt + ak) = kl;
      }
    }
    fence_proxy_async();
    __syncthreads();

    if (wg0) {
      // The sub-tiles on the tensor cores, by warpgroup 0: out^T = S^T
      // r~^T + v^T A^T (64 x 16) and S^T = S^T diag(P) + v^T k~ (64 x hd),
      // each product in 3xTF32: lo hi, hi lo, hi hi
      const int n_sub = (steps + kSub - 1) / kSub;
      for (int q = 0; q < n_sub; ++q) {
        // S^T before the sub-tile as out's A operand, from s_acc: k-step
        // n's a0..a3 are S^T(g (+8), 8 n + t4 (+4)), which the quad's
        // lanes 4 g + t4 / 2 (+2) hold at (t4 % 2) (+2)
        uint32_t ah[S::kKk][4], al[S::kKk][4];
        {
          const int src = (lane & ~3) + t4 / 2;
          const bool odd = t4 & 1;
#pragma unroll
          for (int n = 0; n < S::kKk; ++n) {
            float f[4];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {         // columns t4, t4 + 4
              const float x0 = __shfl_sync(0xffffffffu, s_acc[4 * n],
                                           src + 2 * hf);
              const float x1 = __shfl_sync(0xffffffffu, s_acc[4 * n + 1],
                                           src + 2 * hf);
              const float y0 = __shfl_sync(0xffffffffu, s_acc[4 * n + 2],
                                           src + 2 * hf);
              const float y1 = __shfl_sync(0xffffffffu, s_acc[4 * n + 3],
                                           src + 2 * hf);
              f[2 * hf] = odd ? x1 : x0;
              f[2 * hf + 1] = odd ? y1 : y0;
            }
            const float fr[4] = {f[0], f[1], f[2], f[3]};  // a0 a1 a2 a3
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float hi, lo;
              split(fr[e], hi, lo);
              ah[n][e] = __float_as_uint(hi);
              al[n][e] = __float_as_uint(lo);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float p0 = p_buf[q * HD + 8 * n + 2 * t4];
          const float p1 = p_buf[q * HD + 8 * n + 2 * t4 + 1];
          s_acc[4 * n] *= p0;
          s_acc[4 * n + 1] *= p1;
          s_acc[4 * n + 2] *= p0;
          s_acc[4 * n + 3] *= p1;
        }
        // out's big (hi hi) and small terms by the parity of the k-step:
        // four independent chains of wgmmas, not one
        float ob[2][8], os[2][8];
        reg_fence(s_acc);
#pragma unroll
        for (int n = 0; n < S::kKk; ++n) {
          reg_fence(ah[n]);
          reg_fence(al[n]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < S::kKk; ++kk) {
          const float* bt = rt_buf + (q * S::kKk + kk) * kPadTile;
          const float* btl = rt_lo + (q * S::kKk + kk) * kPadTile;
          wgmma16(os[kk & 1], al[kk], desc(bt, 144, 288), kk > 1);
          wgmma16(os[kk & 1], ah[kk], desc(btl, 144, 288), 1);
          wgmma16(ob[kk & 1], ah[kk], desc(bt, 144, 288), kk > 1);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* a = vt_buf + (q * 2 + kk) * 512;
          const float* bt = at_buf + (q * 2 + kk) * 128;
          const float* bk = kt_buf + (q * 2 + kk) * HD * 8;
          wgmma16(os[kk], desc(a + S::kVt), desc(bt), 1);
          wgmma16(os[kk], desc(a), desc(bt + S::kAt), 1);
          wgmma16(ob[kk], desc(a), desc(bt), 1);
          wgmma_n(s_acc, desc(a + S::kVt), desc(bk));
          wgmma_n(s_acc, desc(a), desc(bk + S::kKt));
          wgmma_n(s_acc, desc(a), desc(bk));
        }
        wgmma_commit_wait();
        reg_fence(s_acc);
        reg_fence(ob[0]);
        reg_fence(ob[1]);
        reg_fence(os[0]);
        reg_fence(os[1]);
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = (ob[0][e] + ob[1][e]) + (os[0][e] + os[1][e]);
        // out^T's rows j = 16 warp + g (+ 8), columns t = 8 n + 2 t4 (+ 1)
        const int j = 16 * warp + g;
        if (j < HD) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int64_t tr = t0 + q * kSub + 8 * (e / 4) + 2 * t4 + e % 2;
            const int jj = j + 8 * ((e / 2) % 2);
            if (tr < t_len && jj < HD)
              out[((b * t_len + tr) * heads + h) * HD + jj] = o[e];
          }
        }
      }
    }
    __syncthreads();          // the stage, A, P and the partials are refilled
  }

  if (!wg0) return;
  const int j = 16 * warp + g;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = j + 8 * (e / 2), i = 8 * n + 2 * t4 + e % 2;
      if (jj < HD)
        state[(static_cast<int64_t>(bh) * HD + i) * HD + jj] = s_acc[4 * n + e];
    }
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
  Maps maps;
  const float* arrays[4] = {r, w, k, v};
  for (int a = 0; a < 4; ++a) {
    const int err = make_map(&maps.m[a], arrays[a], HD, heads, t_len, batch,
                             sh, st, sb);
    if (err != 0) return err;
  }
  rwkv6_wkv_kernel<HD><<<static_cast<unsigned>(blocks), kThreads, bytes,
                         stream>>>(maps, u, out, state, t_len, heads);
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
