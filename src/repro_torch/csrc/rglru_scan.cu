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
// for a, x (T, B, w) and h0 (B, w), all float32, read through their
// strides along T and B (unit stride along w: the model hands (T, B, w)
// views of its (B, T, w) tensors, no copy); h is written through its own
// strides, which the wrapper makes a's, so the model gets a contiguous
// (B, T, w) back.
//
// Design: a single-pass chunked scan that fills the card.  The (T, B, w)
// volume is cut into tiles of kSteps steps x kLanes columns of one batch
// row: 8 x 80 = 640 blocks of 128 threads at the serve path's (512, 4,
// 2560), several per SM.  Each block
//   1. takes its tile from an atomic ticket, chunk-major, so it only ever
//      waits on tiles whose blocks are already running, in any schedule;
//   2. stages its a and x tile into shared memory by TMA: one 3-D box
//      (128 lanes x 1 x 64 steps) of each, completing on one mbarrier
//      (reads past the arrays arrive as 0; the launcher encodes the two
//      maps on the host; arrays whose rows are not on 16-byte boundaries
//      are loaded by the threads instead);
//   3. walks its tile once from shared memory for each lane's aggregate,
//      (A, B) = (prod a, h at the tile's end from 0), and publishes it;
//   4. gets its carry-in by decoupled look-back over the earlier chunks
//      of the same lanes: an inclusive value (h at that tile's end) ends
//      the look-back, an aggregate is composed and the look-back goes on;
//      then publishes its own inclusive value, A * carry + B.  With
//      `ordered` set, only chunk 0's inclusive value ends the look-back
//      and every later chunk's aggregate is composed, whichever flag it
//      has reached: the carry is then one fixed sequence of operations,
//      and two launches give the same bits, whatever order the blocks
//      run in (the gradient's launch; its cost is a look-back over every
//      earlier chunk, T / 64 steps at most);
//   5. walks the tile again from h = carry, one FMA a step, writing h.
// a and x are read from device memory once and h written once.  The sum
// is reassociated only at tile borders (the carries), so results agree
// with the plain walk to a tolerance (tests/test_kernels.py's 1e-4), not
// bit for bit.  The scratch (a flag per tile and a ticket, zeroed, and
// three floats per tile lane) is allocated by the wrapper.
//
// Bound on an NVIDIA H100 SXM (data-sheet rates, 700 W power limit):
// bytes.  The scan must read a and x once (8*T*B*w bytes), h0 (4*B*w)
// and write h (4*T*B*w); its 2*T*B*w flops are nothing beside that.  At
// the serve path's (512, 4, 2560) that is 63 MB, 18.8 us at 3.35 TB/s.
// The look-back adds 12 bytes per tile lane of scratch traffic (1 MB at
// that shape, L2-resident).  PERF.md has the measured time.
//
// Indices are 64-bit: T*B*w may pass 2^31.

#include <cstdint>
#include <cuda_runtime.h>
#ifndef CUDA_CPU_MOCK
#include <cuda.h>
#include <cudaTypedefs.h>
#endif

namespace {

constexpr int kSteps = 64;     // steps of a tile
constexpr int kLanes = 128;    // columns of a tile, one thread each
constexpr int kSmemBytes = 2 * kSteps * kLanes * 4;

enum : int { kEmpty = 0, kAggregate = 1, kInclusive = 2 };

#ifndef CUDA_CPU_MOCK  // tests/test_torch_recurrence_kernels_cpu.py supplies these
using TensorMap = CUtensorMap;

// The TMA map of one (t_len, batch, width) float32 array with element
// strides st, sb (unit along width; both multiples of 4, the base on a
// 16-byte boundary): boxes of kLanes x 1 x kSteps, reads past the array
// as 0.  Host code; 0 or a CUresult.
int make_map(TensorMap* map, const float* base, long long t_len,
             long long batch, long long width, long long st, long long sb) {
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
  if (batch == 1) sb = (width + 3) / 4 * 4;
  if (t_len == 1) st = batch * sb;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(batch),
                              static_cast<cuuint64_t>(t_len)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(sb) * 4,
                                 static_cast<cuuint64_t>(st) * 4};
  const cuuint32_t box[3] = {kLanes, 1, kSteps};
  const cuuint32_t unit[3] = {1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// one (kLanes x kSteps) box of the map at (c, b, t) into dst (128-byte
// aligned), completing on bar
__device__ __forceinline__ void tma_load(float* dst, const TensorMap* map,
                                         int c, int b, int t, uint64_t* bar);

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

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void tma_load(float* dst, const TensorMap* map,
                                         int c, int b, int t, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(bar)), "r"(c), "r"(b), "r"(t)
      : "memory");
}

__device__ __forceinline__ int load_flag(const int* p) {
  int f;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(f) : "l"(p)
               : "memory");
  return f;
}

__device__ __forceinline__ void store_flag(int* p, int f) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(f)
               : "memory");
}
#endif

// a's and x's maps as one kernel parameter, in .param space
struct Maps {
  TensorMap a, x;
};

struct Scratch {
  int* flags;        // per tile: kEmpty, kAggregate or kInclusive
  int* ticket;       // the next tile to take
  float* agg_a;      // per tile lane: prod a over the tile
  float* agg_b;      // per tile lane: h at the tile's end from 0
  float* incl;       // per tile lane: h at the tile's end
};

__global__ void __launch_bounds__(kLanes)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int64_t t_len, int64_t width, int64_t a_st, int64_t a_sb,
                  int64_t x_st, int64_t x_sb, int64_t h_st, int64_t h_sb,
                  int64_t h0_sb, int64_t row_tiles, int64_t lane_tiles,
                  int bulk, int ordered, const __grid_constant__ Maps maps,
                  Scratch sc) {
  extern __shared__ __align__(128) float tile_smem[];
  float* sa = tile_smem;                     // (kSteps, kLanes)
  float* sx = tile_smem + kSteps * kLanes;
  __shared__ uint64_t bar;                   // 8-byte aligned as any uint64_t
  __shared__ int64_t s_tile;
  __shared__ int s_flag;
  const int tid = threadIdx.x;

  if (tid == 0) {
    s_tile = atomicAdd(sc.ticket, 1);
    if (bulk) mbar_init(&bar);
  }
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t chunk = tile / lane_tiles;
  const int64_t lt = tile - chunk * lane_tiles;
  const int64_t b = lt / row_tiles;
  const int64_t c0 = (lt - b * row_tiles) * kLanes;
  const int cols = static_cast<int>(width - c0 < kLanes ? width - c0
                                                          : kLanes);
  const int64_t t0 = chunk * kSteps;
  const int steps = static_cast<int>(t_len - t0 < kSteps ? t_len - t0
                                                           : kSteps);
  const float* ta = a + t0 * a_st + b * a_sb + c0;
  const float* tx = x + t0 * x_st + b * x_sb + c0;
  const bool live = tid < cols;

  if (bulk) {
    if (tid == 0) {                          // two TMA boxes, a's and x's
      mbar_expect(&bar, static_cast<uint32_t>(kSmemBytes));
      tma_load(sa, &maps.a, static_cast<int>(c0), static_cast<int>(b),
               static_cast<int>(t0), &bar);
      tma_load(sx, &maps.x, static_cast<int>(c0), static_cast<int>(b),
               static_cast<int>(t0), &bar);
    }
    mbar_wait(&bar);
  } else {
    if (live) {
      for (int t = 0; t < steps; ++t) {
        sa[t * kLanes + tid] = ta[t * a_st + tid];
        sx[t * kLanes + tid] = tx[t * x_st + tid];
      }
    }
    __syncthreads();
  }

  // the tile's aggregate
  float agg_a = 1.0f, agg_b = 0.0f;
  if (live) {
    for (int t = 0; t < steps; ++t) {
      const float at = sa[t * kLanes + tid];
      agg_a *= at;
      agg_b = fmaf(at, agg_b, sx[t * kLanes + tid]);
    }
  }
  const int64_t lane = tile * kLanes + tid;
  float carry = live ? h0[b * h0_sb + c0 + tid] : 0.0f;
  if (chunk > 0) {
    if (live) {
      __stcg(sc.agg_a + lane, agg_a);
      __stcg(sc.agg_b + lane, agg_b);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) store_flag(sc.flags + tile, kAggregate);

    // look back over the earlier chunks of these lanes
    float ca = 1.0f, cb = 0.0f;              // the chunks between
    for (int64_t j = chunk - 1; j >= 0; --j) {
      const int64_t pred = j * lane_tiles + lt;
      if (tid == 0) {
        int f;
        while ((f = load_flag(sc.flags + pred)) == kEmpty) __nanosleep(20);
        s_flag = f;
      }
      __syncthreads();
      const int f = s_flag;
      __syncthreads();                       // s_flag is rewritten next
      const int64_t pl = pred * kLanes + tid;
      if (f == kInclusive && (j == 0 || !ordered)) {
        if (live) carry = fmaf(ca, __ldcg(sc.incl + pl), cb);
        break;
      }
      if (live) {
        cb = fmaf(ca, __ldcg(sc.agg_b + pl), cb);
        ca *= __ldcg(sc.agg_a + pl);
      }
    }
  }
  if (live) __stcg(sc.incl + lane, fmaf(agg_a, carry, agg_b));
  __threadfence();
  __syncthreads();
  if (tid == 0) store_flag(sc.flags + tile, kInclusive);

  // the tile from its carry
  if (live) {
    float* th = h + t0 * h_st + b * h_sb + c0 + tid;
    float hh = carry;
    for (int t = 0; t < steps; ++t) {
      hh = fmaf(sa[t * kLanes + tid], hh, sx[t * kLanes + tid]);
      th[t * h_st] = hh;
    }
  }
}

int64_t lane_tiles_of(long long batch, long long width) {
  return batch * ((width + kLanes - 1) / kLanes);
}

}  // namespace

// The scratch one launch needs for a (t_len, batch, width) scan: ints
// (flags and the ticket, zeroed by the caller) and floats.
extern "C" long long rglru_scan_scratch_ints(long long t_len, long long batch,
                                             long long width) {
  return (t_len + kSteps - 1) / kSteps * lane_tiles_of(batch, width) + 1;
}

extern "C" long long rglru_scan_scratch_floats(long long t_len,
                                               long long batch,
                                               long long width) {
  return 3 * (rglru_scan_scratch_ints(t_len, batch, width) - 1) * kLanes;
}

// a, x: (t_len, batch, width) float32 with element strides (a_st, a_sb),
// (x_st, x_sb) along T and B and unit stride along width; h: the same
// shape, written through (h_st, h_sb); h0: (batch, width), stride h0_sb
// along B, unit along width.  ordered: 0, or 1 for the look-back that
// gives the same bits every launch (step 4 above).  ints and floats: the
// scratch above, ints zeroed.
extern "C" int rglru_scan_launch(const void* a, const void* x, const void* h0,
                                 void* h, long long t_len, long long batch,
                                 long long width, long long a_st,
                                 long long a_sb, long long x_st,
                                 long long x_sb, long long h_st,
                                 long long h_sb, long long h0_sb,
                                 long long ordered, void* ints, void* floats,
                                 void* stream) {
  if (t_len <= 0 || batch <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lane_tiles = lane_tiles_of(batch, width);
  const long long tiles = rglru_scan_scratch_ints(t_len, batch, width) - 1;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // every row of a tile 16-byte aligned and a multiple of 16 bytes long
  const bool bulk =
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(x)) % 16
          == 0 &&
      (a_st | a_sb | x_st | x_sb | width) % 4 == 0;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  Maps maps{};
  if (bulk) {
    int err = make_map(&maps.a, static_cast<const float*>(a), t_len, batch,
                       width, a_st, a_sb);
    if (err == 0)
      err = make_map(&maps.x, static_cast<const float*>(x), t_len, batch,
                     width, x_st, x_sb);
    if (err != 0) return err;
  }
  auto* fi = static_cast<int*>(ints);
  auto* ff = static_cast<float*>(floats);
  const Scratch sc{fi, fi + tiles, ff, ff + tiles * kLanes,
                   ff + 2 * tiles * kLanes};
  rglru_scan_kernel<<<static_cast<unsigned>(tiles), kLanes, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(h), t_len, width,
      a_st, a_sb, x_st, x_sb, h_st, h_sb, h0_sb,
      (width + kLanes - 1) / kLanes, lane_tiles, bulk ? 1 : 0,
      ordered ? 1 : 0, maps, sc);
  return static_cast<int>(cudaGetLastError());
}
