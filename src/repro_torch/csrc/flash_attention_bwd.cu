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
// dq  — one block per (query tile, b, h), longest causal tiles first.  It
//       writes D for its rows (read by the second launch), then walks the
//       key tiles (causal: up to its last row's position), recomputing S
//       and dO V^T, and accumulates dS K in f32 registers.
// dkdv — one block per (key tile, b, g), longest causal tiles first.  It
//       walks the H / KV query heads of the group in a fixed order and,
//       for each, the query tiles (causal: from the tile holding its first
//       key on), recomputing S^T and V dO^T, and accumulates P^T dO and
//       dS^T Q in f32 registers.  The sum over the group's heads happens
//       inside the block.
//
// Why two launches.  One launch could compute the five products once
// (FlashAttention-3's backward), but then the blocks of all key tiles add
// into each dQ row: with atomics (bits that change from call to call) or,
// deterministically, with semaphores that order the blocks, which a
// crashed and resumed training run (the same bits as an uninterrupted
// one) and a CPU stand-in that runs blocks one after another cannot take;
// a buffer of per-key-tile partials would be 64 x 75.5 MB at the training
// shape below.  So S and dO V^T are recomputed in both launches (7
// products for the gradient's 5; softmax's exp twice).  In exchange,
// every product's left-hand side that is not a staged tile (P^T and dS^T
// in dkdv, dS in dq) is already in registers in the layout the tensor
// cores take it from.
//
// Every output element is written once by one thread after a fixed
// sequence of f32 operations: no atomics, no block waits on another, so
// two launches on the same inputs give the same bits.  Rows and keys past
// Sq and Skv are staged as zeros and masked to P = 0; they are never
// written.
//
// bfloat16 -> tensor cores, `wgmma` (namespace tc).  A block is three
// warpgroups: a producer (`setmaxnreg` leaves it 24 registers) and two
// consumers of 64 rows each (240 registers), so a dkdv block owns 128
// keys and a dq block 128 query rows.  The block's own rows (K and V; Q,
// dO and O) are loaded once by TMA; the other side streams through a ring
// of kStages stages of 64 rows (dkdv: Q and dO tiles, and their lse and D
// copied by the producer warp's 32 lanes with cp.async; dq: K and V
// tiles), full and empty mbarriers between producer and consumers, so
// copies overlap products and the producer never waits on a load.  Per
// staged tile a consumer runs
//
//   S^T = K Q^T, dP^T = V dO^T    wgmma m64n64k16, both operands K-major
//   P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T o (dP^T - D)
//   dV += P^T dO, dK += dS^T Q    wgmma m64n{hd}k16, A from registers,
//                                 B the staged tile read N-major
//
// (dq: S = Q K^T, dP = dO V^T, dS, then dQ += dS K, B = the K tile that
// served S, read N-major).  P and dS are rounded to bf16 once, as pairs
// in the accumulators' own layout, which is the register A operand's; the
// softmax math is f32 with exp as one MUFU ex2.  D is computed in dq from
// the staged O and dO tiles.
//
// The tensor cores and the softmax overlap twice over.  Within a
// consumer, a tile's last products (dV, dK; dQ) wait in registers for the
// next tile and go out in one burst with its first (S, dP), so the
// consumer computes one tile's softmax while the tensor cores run the
// other's products; a consumer holds two ring stages.  Between the two
// consumers, named barriers hand the turn to issue a burst back and
// forth, so one's bursts run while the other computes.  At hd 112 and
// 128 the dkdv accumulators leave too few registers for two tiles in
// flight, and there a tile's products finish before the next tile's
// begin.  Every loaded tile runs every product: a tile that is entirely
// masked for one consumer (its keys all after the tile's queries) is the
// other consumer's diagonal, and it is computed with P = 0 rather than
// given a branch of its own; tiles entirely masked for both are never
// loaded.  Masks apply only on the causal diagonal and ragged tiles.

// Shared memory: every tile is bf16 rows of ceil(hd / 64) TMA boxes of 64
// columns (128 bytes), each box written with TMA's 128-byte swizzle (16-
// byte chunk j of row r at chunk j ^ r % 8), on 1024-byte boundaries.  At
// hd 32 and 112 the box's columns past hd arrive as zeros (out of the
// tensor map's bounds) and no product reads them: one layout for every
// head dim.  A wgmma descriptor of layout type 1 (128-byte swizzle) reads
// it K-major (8-row groups 1024 bytes apart, k-steps 32 bytes apart
// within a row, the box for k >= 64) or N-major (8-row groups along k
// 1024 bytes apart, the next 64 columns one box further).
//
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
// (0.060 ms at 3.35 TB/s): operations bound it.  This design's own seven
// products are 5.41e11 flops, 0.547 ms (dq 0.235 ms, dkdv 0.313 ms).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#ifndef CUDA_CPU_MOCK
#include <cuda.h>
#include <cudaTypedefs.h>
#endif

namespace {

#ifndef CUDA_CPU_MOCK  // tests/test_torch_flash_bwd_cpu.py supplies these
using TensorMap = CUtensorMap;

// The TMA map of one (batch, seq, heads, hd) bf16 array, row-major: boxes
// of 64 columns x 1 head x `rows` positions x 1 batch, 128-byte swizzle;
// columns past hd and positions past seq read as 0.  Host code; 0 or a
// CUresult.
int make_map(TensorMap* map, const void* base, int hd, int heads, int seq,
             int batch, int rows) {
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
  // the encoder needs a current context on this thread; a thread that has
  // not used the runtime yet (autograd's backward thread) has none until
  // the device is set
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaSetDevice(device) != cudaSuccess)
    return static_cast<int>(CUDA_ERROR_INVALID_CONTEXT);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier that completes a phase after `count` arrivals (and the
// transaction bytes announced in the phase)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// arrive, announcing `bytes` of TMA copies for the phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// one box of the map at (column c0, head h, position s, batch b) into dst
// (1024-byte aligned), completing on bar
__device__ __forceinline__ void tma_load(void* dst, const TensorMap* map,
                                         int c0, int h, int s, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(bar)), "r"(c0), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// 4 bytes global -> shared, or zeros when !valid (the source is then
// not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// an arrival on bar once this thread's earlier cp.async copies have
// landed (it counts against the arrivals the barrier was set up for)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

// named barrier `id` of `n` threads: wait for it, or only arrive
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// a warpgroup's register budget: the producer gives registers up, the
// consumers take them (all four warps of the warpgroup execute it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
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

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64, f32) (+)= a (64 x 16) b (16 x 64): bf16, a and b both
// K-major tiles in shared memory by their descriptors; d = a b when add is
// 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(add));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, "
      "%17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[56],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, "
      "%68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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

// The TMA maps of one call (o only for dq)
struct Maps {
  TensorMap q, k, v, o, dout;
};

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWg = 128;               // threads of a warpgroup
constexpr int kTile = 64;              // rows of a consumer and of a ring tile
constexpr int kProducerRegs = 24;      // setmaxnreg: 24 x 128 + 240 x 256
constexpr int kConsumerRegs = 240;     // fits the 65 536 registers of an SM

template <int HD>
struct Cfg {
  static_assert(HD % 16 == 0 && HD <= 128, "whole k-steps, two boxes");
  static constexpr int kBoxes = (HD + 63) / 64;   // 64-column boxes a row
  static constexpr int kSteps = HD / 16;          // k-steps over hd
  // consumer warpgroups of kTile rows: two at every head dim (at hd 128
  // the dK and dV accumulators take 128 of a consumer's 240 registers)
  static constexpr int kConsumers = 2;
  static constexpr int kThreads = kWg * (1 + kConsumers);
  static constexpr int kRows = kTile * kConsumers;  // the block's own rows
  // the ring's depth: a consumer holds two stages (one tile's last
  // products run with the next tile's first), the producer fills the rest
  static constexpr int kStages = 4;
  // dkdv overlaps a tile's last products with the next tile's first only
  // where the registers allow it: at hd 112 and 128 the dK and dV
  // accumulators leave too few for two tiles in flight (ptxas serialises
  // the wgmmas), and a tile's products run to the end before the next
  static constexpr bool kDkdvPipe = HD <= 64;
  static constexpr int kOwn = kRows * 128 * kBoxes;   // bytes of an own tile
  static constexpr int kRing = kTile * 128 * kBoxes;  // of a ring tile
  static constexpr int kBars = 1 + 2 * kStages;       // own, full, empty
  // 1 024 bytes of slack to put the tiles on a 1 024-byte boundary
  static constexpr int kDkdvSmem = 1024 + 2 * kOwn + kStages * 2 * kRing +
                                   kStages * 2 * kTile * 4 + kBars * 8;
  static constexpr int kDqSmem =
      1024 + 3 * kOwn + kStages * 2 * kRing + kBars * 8;
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448, "shared memory");
};

__device__ __forceinline__ unsigned char* align_1024(void* p) {
  unsigned char* c = static_cast<unsigned char*>(p);
  return c + ((1024 - (smem_addr(c) & 1023)) & 1023);
}

// A wgmma descriptor of the bf16 tile at p: layout type 1 (128-byte
// swizzle), start, LBO and SBO in 16-byte units, base offset 0 (every
// 8-row group of a tile starts on a 1 024-byte boundary).
__device__ __forceinline__ uint64_t desc(const unsigned char* p,
                                         uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | uint64_t{1} << 62;
}

// k-step kk (columns 16 kk .. 16 kk + 15 of hd) of rows row0 .. row0 + 63
// of a tile of R rows, K-major: rows of 128 bytes, 8-row groups 1 024
// bytes apart (SBO), the k-step 32 bytes on within the row and in the
// next box from column 64; LBO is unused with a swizzle (1)
template <int R>
__device__ __forceinline__ uint64_t k_major(const unsigned char* tile,
                                            int row0, int kk) {
  return desc(tile + (kk / 4) * (R * 128) + row0 * 128 + (kk % 4) * 32, 16,
              1024);
}

// k-step kk (rows 16 kk .. 16 kk + 15) of a ring tile, N-major along hd:
// 8-row groups along k 1 024 bytes apart (SBO), columns 64 .. 127 one box
// (LBO) on
__device__ __forceinline__ uint64_t n_major(const unsigned char* tile,
                                            int kk) {
  return desc(tile + kk * 16 * 128, kTile * 128, 1024);
}

// (lo, hi) -> one register of two bf16, lo in the low half, each rounded
// to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// acc (64 x N) += w (64 x 64, bf16 pairs w[i] = the accumulator pair 2 i,
// 2 i + 1 of a 64 x 64 product) . t (the 64 rows of a ring tile, read
// N-major): the four k-steps of 16
template <int N>
__device__ __forceinline__ void regs_by_tile(float (&acc)[N],
                                             const uint32_t (&w)[16],
                                             const unsigned char* t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {w[4 * kk], w[4 * kk + 1], w[4 * kk + 2],
                           w[4 * kk + 3]};
    wgmma_rs(acc, a, n_major(t, kk));
  }
}

// The two consumers take turns to issue their tensor-core work (named
// barrier 1: consumer 0's turn, 2: consumer 1's): each issues a tile's
// products in one burst (the previous tile's last products and this
// tile's first) and passes the turn, so that one's softmax runs while the
// other's products do.  Both take and pass the turn at every tile;
// consumer 1 hands over the first turn and keeps its last.
struct Turns {
  int c;
  __device__ __forceinline__ void start() const {
    if (c == 1) named_arrive(1, 2 * kWg);
  }
  __device__ __forceinline__ void take() const { named_sync(1 + c, 2 * kWg); }
  __device__ __forceinline__ void pass(bool last) const {
    if (!(c == 1 && last)) named_arrive(2 - c, 2 * kWg);
  }
};

// rows [row0, row0 + 16) of the warp's accumulator (rows r8 and r8 + 8,
// columns 8 j + t2, + 1), times mul, as bf16 to dst + row * stride;
// rows at or past `valid` skipped
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, int64_t stride,
                                          const float (&acc)[HD / 2],
                                          int row0, int valid, float mul,
                                          int r8, int t2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r8 + 8 * r;
    if (row >= valid) continue;
    __nv_bfloat16* out = dst + row * stride + t2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
dq_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
          float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, Dims p) {
  using C = Cfg<HD>;
  constexpr int S = C::kStages;
  extern __shared__ float4 smem4[];
  unsigned char* qs = align_1024(smem4);          // kRows x HD: Q
  unsigned char* dos = qs + C::kOwn;              // dO
  unsigned char* os = dos + C::kOwn;              // O
  unsigned char* ring = os + C::kOwn;             // per stage: K, V tiles
  uint64_t* own_bar = reinterpret_cast<uint64_t*>(ring + S * 2 * C::kRing);
  uint64_t* full = own_bar + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid / kWg;
  const int n_tiles = (p.sq + C::kRows - 1) / C::kRows;
  const int bh = blockIdx.x % (p.batch * p.heads);
  const int q0 = (n_tiles - 1 - blockIdx.x / (p.batch * p.heads)) * C::kRows;
  const int b = bh / p.heads, h = bh % p.heads;
  const int g = h / (p.heads / p.kv_heads);
  const int valid = min(C::kRows, p.sq - q0);
  const int kv_end = p.causal ? min(p.skv, q0 + valid) : p.skv;
  const int n_kt = (kv_end + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(own_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::kConsumers);   // a consumer warp's lane 0
    }
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: thread 0 stages Q, dO, O, then the K, V ring
    setmaxnreg_dec<kProducerRegs>();
    if (tid != 0) return;
    mbar_expect(own_bar, 3 * C::kOwn);
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) {
      const int at = x * C::kRows * 128;
      tma_load(qs + at, &maps.q, 64 * x, h, q0, b, own_bar);
      tma_load(dos + at, &maps.dout, 64 * x, h, q0, b, own_bar);
      tma_load(os + at, &maps.o, 64 * x, h, q0, b, own_bar);
    }
    for (int it = 0; it < n_kt; ++it) {
      const int s = it % S;
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
      unsigned char* ks = ring + s * 2 * C::kRing;
      mbar_expect(&full[s], 2 * C::kRing);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        const int at = x * kTile * 128;
        tma_load(ks + at, &maps.k, 64 * x, g, it * kTile, b, &full[s]);
        tma_load(ks + C::kRing + at, &maps.v, 64 * x, g, it * kTile, b,
                 &full[s]);
      }
    }
    return;
  }

  // a consumer: query rows qc .. qc + 63
  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1, ct = tid - wg * kWg;
  const int w = ct / 32, lane = ct % 32, r8 = lane / 4, t2 = (lane % 4) * 2;
  const int qc = q0 + c * kTile;
  const int64_t row_stat = static_cast<int64_t>(bh) * p.sq;
  const float sl = p.scale * kLog2e;
  const Turns turns{c};
  turns.start();
  mbar_wait(own_bar, 0);

  // D of this thread's rows (16 w + r8, + 8 of the consumer's), from the
  // staged O and dO: the four threads of a row sum every fourth 16-byte
  // chunk, then add across the four in a fixed order; written for dkdv
  float dd[2], l2[2];
  int row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = c * kTile + 16 * w + r8 + 8 * r;   // row of the own tile
    row[r] = q0 + lr;
    float part = 0.0f;
    for (int j = lane % 4; j < HD / 8; j += 4) {
      const int at = (j / 8) * C::kRows * 128 + lr * 128 +
                     (((j % 8) ^ (lr % 8)) * 16);
      const uint4 ov = *reinterpret_cast<const uint4*>(os + at);
      const uint4 dv = *reinterpret_cast<const uint4*>(dos + at);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
      const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
        const float2 df = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&dw[e]));
        part = fmaf(of.x, df.x, part);
        part = fmaf(of.y, df.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dd[r] = part;
    const bool ok = row[r] < p.sq;
    if (ok && lane % 4 == 0) delta[row_stat + row[r]] = part;
    l2[r] = ok ? lse[row_stat + row[r]] * kLog2e : 0.0f;
  }

  // Every key tile runs its products (a tile of keys all past the
  // consumer's rows is masked to P = 0 like the diagonal: one branch-free
  // pipeline).  Tile it's dS (db) waits for tile it + 1's burst: dS K of
  // tile it, then S and dO V^T of tile it + 1; tile it's stage is
  // released, and db free, once S has landed.
  float acc[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.0f;
  uint32_t db[16];
  float sa[32], dp[32];
  // S, dO V^T of key tile it into sa, dp (two commit groups)
  auto first = [&](int it) {
    const unsigned char* ks = ring + (it % S) * 2 * C::kRing;
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk)
      wgmma_ss(sa, k_major<C::kRows>(qs, c * kTile, kk),
               k_major<kTile>(ks, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk)
      wgmma_ss(dp, k_major<C::kRows>(dos, c * kTile, kk),
               k_major<kTile>(ks + C::kRing, 0, kk), kk);
    wgmma_commit();
  };
  // P of key tile it into sa, from S; rows past Sq have Q = dO = 0 and
  // lse = D = 0, so their dS is 0 unmasked
  auto softmax = [&](int it) {
    const int k0 = it * kTile;
#pragma unroll
    for (int e = 0; e < 32; ++e)
      sa[e] = ex2(fmaf(sa[e], sl, -l2[(e >> 1) & 1]));
    if ((p.causal && k0 >= qc) || k0 + kTile > p.skv) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = k0 + 8 * (e >> 2) + t2 + (e & 1);
        if (key >= p.skv || (p.causal && key > row[(e >> 1) & 1]))
          sa[e] = 0.0f;
      }
    }
  };
  // dS = P o (dO V^T - D) into dp
  auto grad = [&]() {
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = sa[e] * (dp[e] - dd[(e >> 1) & 1]);
  };
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) db[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
  };

  mbar_wait(&full[0], 0);
  turns.take();
  wgmma_fence();
  first(0);
  turns.pass(n_kt == 1);
  wgmma_wait<1>();
  reg_fence(sa);
  softmax(0);
  wgmma_wait<0>();
  reg_fence(dp);
  grad();
  pack();
  for (int it = 1; it < n_kt; ++it) {
    const int s = it % S, held = (it - 1) % S;
    mbar_wait(&full[s], (it / S) & 1);
    turns.take();
    wgmma_fence();
    regs_by_tile(acc, db, ring + held * 2 * C::kRing);   // dQ += dS K
    wgmma_commit();
    first(it);
    turns.pass(it + 1 == n_kt);
    wgmma_wait<1>();                   // the held tile's product and S
    reg_fence(db);
    reg_fence(sa);
    if (lane == 0) mbar_arrive(&empty[held]);
    softmax(it);
    wgmma_wait<0>();
    reg_fence(dp);                     // dO V^T has landed
    grad();
    pack();
  }
  wgmma_fence();
  regs_by_tile(acc, db, ring + ((n_kt - 1) % S) * 2 * C::kRing);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
  if (lane == 0) mbar_arrive(&empty[(n_kt - 1) % S]);
  const int64_t pos_stride = static_cast<int64_t>(p.heads) * HD;
  store_acc<HD>(dq + static_cast<int64_t>(b) * p.sq * pos_stride +
                    static_cast<int64_t>(h) * HD,
                pos_stride, acc, qc + 16 * w, p.sq, p.scale, r8, t2);
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
dkdv_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
            const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, Dims p) {
  using C = Cfg<HD>;
  constexpr int S = C::kStages;
  extern __shared__ float4 smem4[];
  unsigned char* ks = align_1024(smem4);          // kRows x HD: K
  unsigned char* vs = ks + C::kOwn;               // V
  unsigned char* ring = vs + C::kOwn;             // per stage: Q, dO tiles
  // per stage: lse and D of the tile's 64 rows
  float* stats = reinterpret_cast<float*>(ring + S * 2 * C::kRing);
  uint64_t* own_bar = reinterpret_cast<uint64_t*>(stats + S * 2 * kTile);
  uint64_t* full = own_bar + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid / kWg;
  const int group = p.heads / p.kv_heads;
  const int bg = blockIdx.x % (p.batch * p.kv_heads);
  const int k0 = blockIdx.x / (p.batch * p.kv_heads) * C::kRows;  // longest
  const int b = bg / p.kv_heads, g = bg % p.kv_heads;               // first
  const int n_qt = (p.sq + kTile - 1) / kTile;
  const int qt0 = p.causal ? k0 / kTile : 0;      // the first key's tile
  const int per_head = max(n_qt - qt0, 0);
  const int n_iter = group * per_head;            // the group's heads in turn

  if (tid == 0) {
    mbar_init(own_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 33);     // every producer lane's copies, the TMA
      mbar_init(&empty[s], 4 * C::kConsumers);   // a consumer warp's lane 0
    }
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: warp 0 stages K and V, then the ring of (Q, dO, lse,
    // D); every lane copies two rows' lse and D by cp.async, arriving
    // once they have landed, and lane 0 announces the tiles' bytes
    setmaxnreg_dec<kProducerRegs>();
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      mbar_expect(own_bar, 2 * C::kOwn);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        const int at = x * C::kRows * 128;
        tma_load(ks + at, &maps.k, 64 * x, g, k0, b, own_bar);
        tma_load(vs + at, &maps.v, 64 * x, g, k0, b, own_bar);
      }
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % S;
      const int h = g * group + it / per_head;
      const int q0 = (qt0 + it % per_head) * kTile;
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
      const int64_t stat = (static_cast<int64_t>(b) * p.heads + h) * p.sq;
      float* st = stats + s * 2 * kTile;
      for (int i = lane; i < kTile; i += 32) {
        const bool ok = q0 + i < p.sq;
        const int64_t at = ok ? stat + q0 + i : 0;
        cp_async4(st + i, lse + at, ok);
        cp_async4(st + kTile + i, delta + at, ok);
      }
      cp_async_arrive(&full[s]);
      if (lane == 0) {
        unsigned char* qs = ring + s * 2 * C::kRing;
        mbar_expect(&full[s], 2 * C::kRing);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          const int at = x * kTile * 128;
          tma_load(qs + at, &maps.q, 64 * x, h, q0, b, &full[s]);
          tma_load(qs + C::kRing + at, &maps.dout, 64 * x, h, q0, b,
                   &full[s]);
        }
      }
    }
    return;
  }

  // a consumer: keys kc .. kc + 63
  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1, ct = tid - wg * kWg;
  const int w = ct / 32, lane = ct % 32, r8 = lane / 4, t2 = (lane % 4) * 2;
  const int kc = k0 + c * kTile;
  int key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key[r] = kc + 16 * w + r8 + 8 * r;
  const float sl = p.scale * kLog2e;
  const Turns turns{c};
  if (n_iter > 0) turns.start();
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) dka[e] = dva[e] = 0.0f;
  mbar_wait(own_bar, 0);

  // As in dq: every query tile runs its products (a tile of queries all
  // before the consumer's keys masked to P = 0), and tile it's P^T and
  // dS^T (pb, db) wait for tile it + 1's burst: P^T dO and dS^T Q of tile
  // it, then S^T and V dO^T of tile it + 1.
  uint32_t pb[16], db[16];
  float sa[32], dp[32];
  auto first = [&](int it) {
    const unsigned char* qs = ring + (it % S) * 2 * C::kRing;
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk)
      wgmma_ss(sa, k_major<C::kRows>(ks, c * kTile, kk),
               k_major<kTile>(qs, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk)
      wgmma_ss(dp, k_major<C::kRows>(vs, c * kTile, kk),
               k_major<kTile>(qs + C::kRing, 0, kk), kk);
    wgmma_commit();
  };

  auto softmax = [&](int it) {
    const int q0 = (qt0 + it % per_head) * kTile;
    const float* st = stats + (it % S) * 2 * kTile;     // lse
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float l2 = st[8 * (e >> 2) + t2 + (e & 1)] * kLog2e;
      sa[e] = ex2(fmaf(sa[e], sl, -l2));
    }
    if ((p.causal && q0 <= kc) || q0 + kTile > p.sq || kc + kTile > p.skv) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qi = q0 + 8 * (e >> 2) + t2 + (e & 1), kr = key[(e >> 1) & 1];
        if (qi >= p.sq || kr >= p.skv || (p.causal && kr > qi)) sa[e] = 0.0f;
      }
    }
  };
  auto grad = [&](int it) {
    const float* dl = stats + (it % S) * 2 * kTile + kTile;
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = sa[e] * (dp[e] - dl[8 * (e >> 2) + t2 + (e & 1)]);
  };
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pb[i] = pack_bf16(sa[2 * i], sa[2 * i + 1]);
      db[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    }
  };
  // dV += P^T dO, dK += dS^T Q of the tile in stage `held`
  auto last = [&](int held) {
    const unsigned char* hq = ring + held * 2 * C::kRing;
    regs_by_tile(dva, pb, hq + C::kRing);
    regs_by_tile(dka, db, hq);
    wgmma_commit();
  };

  if (n_iter > 0 && !C::kDkdvPipe) {
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      turns.take();
      wgmma_fence();
      first(it);
      turns.pass(it + 1 == n_iter);
      wgmma_wait<1>();
      reg_fence(sa);                   // S^T has landed
      softmax(it);
      wgmma_wait<0>();
      reg_fence(dp);                   // V dO^T has landed
      grad(it);
      pack();
      wgmma_fence();
      last(s);
      wgmma_wait<0>();
      reg_fence(pb);
      reg_fence(db);
      reg_fence(dva);
      reg_fence(dka);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  } else if (n_iter > 0) {
    mbar_wait(&full[0], 0);
    turns.take();
    wgmma_fence();
    first(0);
    turns.pass(n_iter == 1);
    wgmma_wait<1>();
    reg_fence(sa);
    softmax(0);
    wgmma_wait<0>();
    reg_fence(dp);
    grad(0);
    pack();
    for (int it = 1; it < n_iter; ++it) {
      const int s = it % S, held = (it - 1) % S;
      mbar_wait(&full[s], (it / S) & 1);
      turns.take();
      wgmma_fence();
      last(held);
      first(it);
      turns.pass(it + 1 == n_iter);
      wgmma_wait<1>();                 // the held tile's products and S^T
      reg_fence(pb);
      reg_fence(db);
      reg_fence(sa);
      if (lane == 0) mbar_arrive(&empty[held]);
      softmax(it);
      wgmma_wait<0>();
      reg_fence(dp);                   // V dO^T has landed
      grad(it);
      pack();
    }
    wgmma_fence();
    last((n_iter - 1) % S);
    wgmma_wait<0>();
    reg_fence(dva);
    reg_fence(dka);
    if (lane == 0) mbar_arrive(&empty[(n_iter - 1) % S]);
  }
  const int64_t kv_stride = static_cast<int64_t>(p.kv_heads) * HD;
  const int64_t base = static_cast<int64_t>(b) * p.skv * kv_stride +
                       static_cast<int64_t>(g) * HD;
  store_acc<HD>(dk + base, kv_stride, dka, kc + 16 * w, p.skv, p.scale, r8,
                t2);
  store_acc<HD>(dv + base, kv_stride, dva, kc + 16 * w, p.skv, 1.0f, r8, t2);
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

// The TMA maps of q, dout and o (boxes of `q_rows` positions) and of k
// and v (`kv_rows`); 0 or a CUresult
template <int HD>
int make_maps(Maps& m, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const Dims& p, int q_rows,
              int kv_rows) {
  int err = make_map(&m.q, q, HD, p.heads, p.sq, p.batch, q_rows);
  if (!err) err = make_map(&m.dout, dout, HD, p.heads, p.sq, p.batch, q_rows);
  if (!err && o) err = make_map(&m.o, o, HD, p.heads, p.sq, p.batch, q_rows);
  if (!err) err = make_map(&m.k, k, HD, p.kv_heads, p.skv, p.batch, kv_rows);
  if (!err) err = make_map(&m.v, v, HD, p.kv_heads, p.skv, p.batch, kv_rows);
  return err;
}

template <int HD>
int launch_dq(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* delta,
              void* dq, const Dims& p, cudaStream_t s) {
  if (dtype == 0) {
    const int grid = (p.sq + 63) / 64 * p.batch * p.heads;
    static bool done = false;
    constexpr int bytes = cc::smem_bytes<HD>();
    if (int err = allow_smem(cc::dq_kernel<HD>, bytes, done)) return err;
    cc::dq_kernel<HD><<<grid, cc::kThreads, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
        p);
  } else {
    using C = tc::Cfg<HD>;
    Maps m{};
    if (int err = make_maps<HD>(m, q, k, v, o, dout, p, C::kRows, tc::kTile))
      return err;
    const int grid = (p.sq + C::kRows - 1) / C::kRows * p.batch * p.heads;
    static bool done = false;
    constexpr int bytes = C::kDqSmem;
    if (int err = allow_smem(tc::dq_kernel<HD>, bytes, done)) return err;
    tc::dq_kernel<HD><<<grid, C::kThreads, bytes, s>>>(
        m, lse, delta, static_cast<__nv_bfloat16*>(dq), p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkdv(int dtype, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, const Dims& p, cudaStream_t s) {
  if (dtype == 0) {
    const int grid = (p.skv + 63) / 64 * p.batch * p.kv_heads;
    static bool done = false;
    constexpr int bytes = cc::smem_bytes<HD>();
    if (int err = allow_smem(cc::dkdv_kernel<HD>, bytes, done)) return err;
    cc::dkdv_kernel<HD><<<grid, cc::kThreads, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), p);
  } else {
    using C = tc::Cfg<HD>;
    Maps m{};
    if (int err = make_maps<HD>(m, q, k, v, nullptr, dout, p, tc::kTile,
                                C::kRows))
      return err;
    const int grid = (p.skv + C::kRows - 1) / C::kRows * p.batch * p.kv_heads;
    static bool done = false;
    constexpr int bytes = C::kDkdvSmem;
    if (int err = allow_smem(tc::dkdv_kernel<HD>, bytes, done)) return err;
    tc::dkdv_kernel<HD><<<grid, C::kThreads, bytes, s>>>(
        m, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), p);
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
