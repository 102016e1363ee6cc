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
// vals' dtype.  Keys outside [0, bins) are dropped at both ends (sorted,
// the negative keys come first and the keys >= bins last; the Pallas
// kernel's one-hot drops both).  Empty bins are written 0.
//
// Design: one pass over the rows, parallel over rows and not over bins,
// so a block's work does not depend on how the keys are spread.
//   * The grid is ceil(T / R) row chunks times the column tiles.  A
//     block's 256 threads are `lanes` column lanes (V adjacent columns
//     each, V = 4 f32 / 8 bf16 by 16-byte loads where d and the pointers
//     allow, else 1) times 256 / lanes row groups; each thread walks a
//     run of consecutive rows.  At d = 1 a run is 4 rows, one int4 of
//     keys and one float4 (bf16: 8 bytes) of values, so a warp's loads
//     are contiguous and R = 1 024; at d > 1 a run is 16 rows, each a
//     V-wide load across the columns, R = 16 * 256 / lanes.
//   * No search: a row whose key differs from the row before is a segment
//     head.  A segment that starts and ends inside a run is summed in a
//     register and written by that thread; so are the bins strictly
//     between consecutive keys (zeros), [0, first key) and (last key,
//     bins) (keys clipped to [-1, bins]).  Every bin is written once.
//   * A segment that crosses runs: each run's (head seen, open sum at its
//     end) pairs are combined left to right, a head restarting the sum:
//     a segmented scan by warp shuffles, then over the 8 warps in shared
//     memory.  The thread whose first segment end belongs to a segment
//     that started in an earlier run adds the scan's carry to its partial.
//   * Across chunks: each block publishes its chunk's aggregate (head
//     seen, open sum at its end), one 64-bit word per column that also
//     carries the launch's epoch, so a reader never sees a sum without
//     its flag and no fence is needed.  A block whose first segment
//     started in an earlier chunk looks back over the earlier chunks'
//     aggregates to the nearest chunk with a head: first one warp over
//     the nearest 32 / lanes chunks at a time, waiting only for those up
//     to the nearest head, then, past 2 such windows, the whole block over
//     4 * 256 / lanes chunks at a time; it sums them in a fixed order.  It
//     reads aggregates only, never another block's result, so the order
//     of every sum is fixed by chunk and lane and not by arrival: the
//     same inputs give the same bits on every call.
//   * Blocks take their chunk from an atomic ticket, so a block only
//     waits on chunks whose blocks are already running; while the ticket
//     is in flight a block loads the chunk of its own index, the usual
//     answer, and loads again only if the ticket differs.  The block that
//     takes the last ticket resets it to 0 for the next launch; the words
//     carry the launch's epoch (from the wrapper, which caches the scratch
//     per device and stream), so no launch zeroes them.
//   * The walk over a run is predicated code, one store per segment end;
//     the zeros after a gap in the keys, rare, are written in a loop over
//     a bit mask of the heads that follow one (gap loops inline in the
//     unrolled walk multiply its code and its divergent branches).
// No atomics on values.  The sum's order differs from the TPU's
// per-512-row MXU blocks, so float outputs agree with the plain version
// to a tolerance, not bit for bit; integer-valued sums below 2^24
// (histogram counts) are exact.
//
// Bound on an NVIDIA H100 SXM (3.35 TB/s): bytes.  The commit must read
// the keys (4T bytes) and the values (T*d*sizeof(val)) once and write the
// output (bins*d*sizeof(out)); its T*d additions are far below the f32
// rate.  At the trace path's sizes (T <= 37 505, bins 64, d 1: 0.3 MB,
// 0.09 us) a launch's own floor, not the bytes, bounds it.  PERF.md has
// the measured times.
//
// Indices are 64-bit: T*d may pass 2^31.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsNarrow = 4;            // rows of a run at d = 1
constexpr int kRowsWide = 16;             // rows of a run at d > 1
constexpr int kNearSteps = 2;             // warp 0's look-back windows
constexpr int kLook = 4;                  // chunks a row group reads per
                                          // wide look-back window
constexpr unsigned kFull = 0xffffffffu;

#ifndef CUDA_CPU_MOCK  // tests/test_torch_colibri_scatter_cpu.py supplies these
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}
#endif

// V adjacent elements of type T as floats, loaded at once (8 or 16 bytes
// when V > 1: the address must be aligned to that) and stored at once.
template <typename T, int V>
struct Lanes;

template <>
struct Lanes<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    x[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *p = x[0];
  }
};

template <>
struct Lanes<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    x[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    *p = __float2bfloat16_rn(x[0]);
  }
};

template <>
struct Lanes<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = float4{x[0], x[1], x[2], x[3]};
  }
};

template <>
struct Lanes<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {             // element 2i in the low half
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i])))
             | static_cast<uint32_t>(
                   __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i + 1])))
                   << 16;
    *reinterpret_cast<uint4*>(p) = uint4{w[0], w[1], w[2], w[3]};
  }
};

template <>
struct Lanes<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(q.x << 16);
    x[1] = __uint_as_float(q.x & 0xffff0000u);
    x[2] = __uint_as_float(q.y << 16);
    x[3] = __uint_as_float(q.y & 0xffff0000u);
  }
};

// elements of T in 16 bytes
template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(T));
}

// a key clipped to [-1, bins]: the zeros between two keys are the bins
// strictly between their clipped values
__device__ __forceinline__ int clip(int k, int bins) {
  return k < 0 ? -1 : (k >= bins ? bins : k);
}

// A chunk's aggregate for one column, published as one 64-bit word:
// (epoch << 1 | head seen) in the high half, the open sum's bits in the
// low half.  A word from an earlier launch carries an older epoch.
__device__ __forceinline__ unsigned long long pack(int epoch, int head,
                                                   float sum) {
  return static_cast<unsigned long long>((epoch << 1) | head) << 32
         | __float_as_uint(sum);
}

struct Scratch {
  unsigned long long* ticket;  // the next block's ticket; 0 between launches
  unsigned long long* words;   // per (chunk, column): its aggregate
};

template <typename T, int V, int R>
__global__ void __launch_bounds__(kThreads)
colibri_commit_kernel(const int32_t* __restrict__ keys,
                      const T* __restrict__ vals, T* __restrict__ out,
                      int64_t t, int d, int bins, int lanes, int ctiles,
                      int blocks, int keys_vec, int vals_vec, Scratch sc,
                      int epoch) {
  __shared__ int s_ticket, s_need;
  __shared__ int w_head[kWarps][32];
  __shared__ float w_sum[kWarps][32 * V];
  __shared__ int lb_min[2][kWarps];         // look-back, by window parity
  __shared__ float lb_sum[2][kWarps][32 * V];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ell = tid & (lanes - 1);        // column lane
  const int g = tid / lanes;                // row group
  const int groups = kThreads / lanes;
  constexpr int kVec = R * static_cast<int>(sizeof(T)) >= 16 ? vec_of<T>()
                                                            : R;

  unsigned long long ticket = 0;
  if (tid == 0) ticket = atomicAdd(sc.ticket, 1ULL);

  // ---- the run's keys and values, into registers ----
  int64_t chunk, a;
  int ct, n, col0;
  bool cols;
  int k[R];
  int k_before, k_after;
  float x1[R];                              // d = 1: the run's values
  auto load_run = [&](int tk) {
    chunk = tk / ctiles;
    ct = tk - static_cast<int>(chunk) * ctiles;
    a = (chunk * groups + g) * R;
    n = a < t ? static_cast<int>(t - a < R ? t - a : R) : 0;
    col0 = (ct * lanes + ell) * V;
    cols = col0 < d;                        // V > 1 only when V divides d
    if (n == R && keys_vec) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const int4 w = reinterpret_cast<const int4*>(keys + a)[q];
        k[4 * q] = w.x;
        k[4 * q + 1] = w.y;
        k[4 * q + 2] = w.z;
        k[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) k[j] = j < n ? keys[a + j] : 0;
    }
    k_before = a > 0 && n > 0 ? keys[a - 1] : 0;
    k_after = a + R < t ? keys[a + R] : 0;
    if (V == 1 && d == 1) {
      if (n == R && vals_vec) {
#pragma unroll
        for (int q = 0; q < R / kVec; ++q)
          Lanes<T, kVec>::load(vals + a + q * kVec, x1 + q * kVec);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (j < n) Lanes<T, 1>::load(vals + a + j, x1 + j);
      }
    }
  };
  load_run(blockIdx.x);                     // the likely chunk, while the
  if (tid == 0) {                           // ticket is in flight
    s_ticket = static_cast<int>(ticket);
    if (s_ticket == blocks - 1) atomicExch(sc.ticket, 0ULL);  // all taken
    s_need = 0;
  }
  __syncthreads();
  if (s_ticket != static_cast<int>(blockIdx.x)) load_run(s_ticket);

  // ---- the run's segments: sums in registers, each end committed once ----
  const bool first = a == 0;                // the run holds row 0
  const bool at_end = a + n == t;           // the run holds row T-1
  bool head = false, held = false;
  int held_key = 0;
  unsigned gaps = 0;                        // heads after a gap of bins
  float acc[V] = {}, part[V] = {};
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const bool row = j < n;
    const int kj = k[j];
    float x[V];
    if (V == 1 && d == 1) {
      x[0] = row ? x1[j] : 0.0f;
    } else if (row && cols) {
      Lanes<T, V>::load(vals + (a + j) * d + col0, x);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) x[c] = 0.0f;
    }
    const int kp = j > 0 ? k[j - 1] : k_before;
    const bool hd = row && ((j == 0 && first) || kj != kp);    // a head
    const bool en = row && ((at_end && j == n - 1)             // an end
                            || kj != (j + 1 < R ? k[j + 1] : k_after));
    const int lo = j == 0 && first ? -1 : clip(kp, bins);
    if (hd && clip(kj, bins) > lo + 1) gaps |= 1u << j;
    head = head || hd;
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = (hd ? 0.0f : acc[c]) + x[c];
    if (en && head && cols && kj >= 0 && kj < bins)
      Lanes<T, V>::store(out + static_cast<int64_t>(kj) * d + col0, acc);
    if (en && !head) {                      // started before this run
      held = true;
      held_key = kj;
#pragma unroll
      for (int c = 0; c < V; ++c) part[c] = acc[c];
    }
  }
  // zeros: the bins before each head that follows a gap, after the last
  // key, and every bin of an empty stream
  const float zero[V] = {};
  auto zeros = [&](int lo, int hi) {        // the bins strictly between
    if (cols)
      for (int bin = lo + 1; bin < hi; ++bin)
        Lanes<T, V>::store(out + static_cast<int64_t>(bin) * d + col0, zero);
  };
  while (gaps) {
    const int j = __ffs(static_cast<int>(gaps)) - 1;
    gaps &= gaps - 1;
    zeros(j == 0 && first ? -1 : clip(j > 0 ? keys[a + j - 1] : k_before,
                                      bins),
          clip(keys[a + j], bins));
  }
  if (n > 0 && at_end) zeros(clip(keys[t - 1], bins), bins);
  if (t == 0 && cols)
    for (int bin = g; bin < bins; bin += groups)
      Lanes<T, V>::store(out + static_cast<int64_t>(bin) * d + col0, zero);

  // ---- the block: segmented scan of (head, open sum) over the runs ----
  int h = head;
  float s[V];
#pragma unroll
  for (int c = 0; c < V; ++c) s[c] = acc[c];
  for (int off = lanes; off < 32; off <<= 1) {
    const int hp = __shfl_up_sync(kFull, h, off);
    float sp[V];
#pragma unroll
    for (int c = 0; c < V; ++c) sp[c] = __shfl_up_sync(kFull, s[c], off);
    if (lane >= off) {
      if (!h) {
#pragma unroll
        for (int c = 0; c < V; ++c) s[c] = sp[c] + s[c];
      }
      h |= hp;
    }
  }
  int xh = __shfl_up_sync(kFull, h, lanes);  // exclusive, in the warp
  float xs[V];
#pragma unroll
  for (int c = 0; c < V; ++c) xs[c] = __shfl_up_sync(kFull, s[c], lanes);
  if (lane < lanes) {
    xh = 0;
#pragma unroll
    for (int c = 0; c < V; ++c) xs[c] = 0.0f;
  }
  if (lane >= 32 - lanes) {                 // the warp's last row group
    w_head[warp][ell] = h;
#pragma unroll
    for (int c = 0; c < V; ++c) w_sum[warp][ell * V + c] = s[c];
  }
  __syncthreads();
  if (!xh) {                                // the earlier warps, in order
    int ph = 0;
    float ps[V] = {};
    for (int w = 0; w < warp; ++w) {
      if (w_head[w][ell]) {
        ph = 1;
#pragma unroll
        for (int c = 0; c < V; ++c) ps[c] = w_sum[w][ell * V + c];
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) ps[c] = ps[c] + w_sum[w][ell * V + c];
      }
    }
    xh = ph;
#pragma unroll
    for (int c = 0; c < V; ++c) xs[c] = ps[c] + xs[c];
  }

  // ---- publish the chunk's aggregate: one word per column, no fence ----
  if (g == groups - 1 && cols) {
#pragma unroll
    for (int c = 0; c < V; ++c)
      store_word(sc.words + chunk * d + col0 + c,
                 pack(epoch, xh | head, head ? acc[c] : xs[c] + acc[c]));
  }
  const bool commit_held = held && held_key >= 0 && held_key < bins;
  if (commit_held && !xh) s_need = 1;       // carries from earlier chunks
  __syncthreads();

  // ---- look back over earlier chunks' aggregates, nearest first ----
  // First warp 0 alone, over windows of the nearest 32 / lanes chunks
  // (one per row group of the warp, up to kNearSteps windows), each done
  // as soon as every chunk up to the nearest one with a head is
  // published; then, for a segment longer than that, the
  // whole block over windows of groups * kLook chunks, row group g
  // reading the kLook chunks at offsets g * kLook .. g * kLook + kLook - 1
  // past the window's start.  A lane without a column reads the tile's
  // first column, for the heads.
  float carry[V] = {};
  if (s_need) {
    const int col = cols ? col0 : ct * lanes * V;
    const int near_groups = 32 / lanes;
    if (warp == 0) {
      float mine[V] = {};                   // lanes < lanes: the carry
      int nearest = near_groups;            // group of the nearest head
      for (int step = 0; step < kNearSteps && nearest == near_groups;
           ++step) {
        const int64_t j = chunk - 1 - step * near_groups - g;
        unsigned long long w[V];
#pragma unroll
        for (int c = 0; c < V; ++c)
          w[c] = j >= 0 ? load_word(sc.words + j * d + col + (cols ? c : 0))
                        : 0ULL;
        for (;;) {
          bool ready = true;
#pragma unroll
          for (int c = 0; c < V; ++c)
            ready = ready && static_cast<int>(w[c] >> 33) == epoch;
          ready = ready || j < 0;
          const unsigned readies = __ballot_sync(kFull, ready);
          const unsigned heads =
              __ballot_sync(kFull, ready && j >= 0 && ((w[0] >> 32) & 1));
          nearest = heads ? (__ffs(static_cast<int>(heads)) - 1) / lanes
                          : near_groups;
          const int upto = heads ? (nearest + 1) * lanes : 32;
          const unsigned need = upto == 32 ? kFull : (1u << upto) - 1;
          if ((readies & need) == need) break;
          __nanosleep(32);
          if (!ready) {
#pragma unroll
            for (int c = 0; c < V; ++c)
              w[c] = load_word(sc.words + j * d + col + (cols ? c : 0));
          }
        }
        float win[V];
#pragma unroll
        for (int c = 0; c < V; ++c)
          win[c] = cols && j >= 0 && g <= nearest
                       ? __uint_as_float(static_cast<uint32_t>(w[c])) : 0.0f;
        for (int off = 16; off >= lanes; off >>= 1) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            win[c] += __shfl_down_sync(kFull, win[c], off);
        }
#pragma unroll
        for (int c = 0; c < V; ++c) mine[c] = win[c] + mine[c];
      }
      if (lane < lanes) {
#pragma unroll
        for (int c = 0; c < V; ++c) lb_sum[1][0][ell * V + c] = mine[c];
      }
      if (lane == 0) lb_min[1][0] = nearest;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < V; ++c) carry[c] = lb_sum[1][0][ell * V + c];
    if (lb_min[1][0] == near_groups) {      // no head among them: go wide
      for (int64_t base = chunk - 1 - kNearSteps * near_groups, win = 0;;
           base -= groups * kLook, ++win) {
        const int par = static_cast<int>(win & 1);
        // all the window's words in flight at once, then wait for any
        // that are not yet published
        unsigned long long w[kLook][V];
#pragma unroll
        for (int u = 0; u < kLook; ++u) {
          const int64_t j = base - g * kLook - u;
#pragma unroll
          for (int c = 0; c < V; ++c)
            w[u][c] = j >= 0
                          ? load_word(sc.words + j * d + col + (cols ? c : 0))
                          : 0ULL;
        }
        int near = groups * kLook;          // this thread's nearest head
        float sj[kLook][V] = {};
#pragma unroll
        for (int u = 0; u < kLook; ++u) {
          const int64_t j = base - g * kLook - u;
          if (j < 0) continue;
#pragma unroll
          for (int c = 0; c < V; ++c) {
            while (static_cast<int>(w[u][c] >> 33) != epoch) {
              __nanosleep(32);
              w[u][c] = load_word(sc.words + j * d + col + (cols ? c : 0));
            }
            if ((w[u][c] >> 32) & 1) near = min(near, g * kLook + u);
            sj[u][c] = cols ? __uint_as_float(static_cast<uint32_t>(w[u][c]))
                            : 0.0f;
          }
        }
        const int wmin = __reduce_min_sync(kFull, near);
        if (lane == 0) lb_min[par][warp] = wmin;
        __syncthreads();
        int nearest = groups * kLook;       // the nearest chunk with a head
        for (int w2 = 0; w2 < kWarps; ++w2)
          nearest = min(nearest, lb_min[par][w2]);
        float mine[V] = {};                 // this thread's chunks up to it
#pragma unroll
        for (int u = 0; u < kLook; ++u) {
          if (g * kLook + u <= nearest) {
#pragma unroll
            for (int c = 0; c < V; ++c) mine[c] = mine[c] + sj[u][c];
          }
        }
        for (int off = 16; off >= lanes; off >>= 1) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            mine[c] += __shfl_down_sync(kFull, mine[c], off);
        }
        if (lane < lanes) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            lb_sum[par][warp][ell * V + c] = mine[c];
        }
        __syncthreads();
        float wsum[V];
#pragma unroll
        for (int c = 0; c < V; ++c) wsum[c] = lb_sum[par][0][ell * V + c];
        for (int w2 = 1; w2 < kWarps; ++w2) {
#pragma unroll
          for (int c = 0; c < V; ++c)
            wsum[c] = wsum[c] + lb_sum[par][w2][ell * V + c];
        }
#pragma unroll
        for (int c = 0; c < V; ++c) carry[c] = wsum[c] + carry[c];
        if (nearest < groups * kLook) break;
      }
    }
  }
  if (commit_held && cols) {
    float y[V];
#pragma unroll
    for (int c = 0; c < V; ++c)
      y[c] = (xh ? xs[c] : carry[c] + xs[c]) + part[c];
    Lanes<T, V>::store(out + static_cast<int64_t>(held_key) * d + col0, y);
  }
}

// The launch's shape: column lanes of V columns, row groups, chunks of
// rows and column tiles.
struct Plan {
  int lanes, ctiles;
  long long chunks;
};

Plan plan_of(long long t, int d, int v) {
  const int slots = (d + v - 1) / v;
  int lanes = 1;
  while (lanes < slots && lanes < 32) lanes *= 2;
  const long long rows = static_cast<long long>(kThreads / lanes)
                         * (d == 1 ? kRowsNarrow : kRowsWide);
  const long long chunks = t > 0 ? (t + rows - 1) / rows : 1;
  return Plan{lanes, (slots + lanes - 1) / lanes, chunks};
}

template <typename T>
int launch(const void* keys, const void* vals, void* out, long long t, int d,
           int bins, unsigned long long* scratch, long long n_words,
           int epoch, cudaStream_t stream) {
  constexpr int kVec = vec_of<T>();
  const bool wide =
      d % kVec == 0
      && (reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(out))
             % 16 == 0;
  const Plan p = plan_of(t, d, wide ? kVec : 1);
  const long long blocks = p.chunks * p.ctiles;
  if (blocks > 0x7fffffffLL || 1 + p.chunks * d > n_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc{scratch, scratch + 1};
  const int keys_vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  const int vals_vec = reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* x = static_cast<const T*>(vals);
  auto* o = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  auto kern = wide ? colibri_commit_kernel<T, kVec, kRowsWide>
                   : d == 1 ? colibri_commit_kernel<T, 1, kRowsNarrow>
                            : colibri_commit_kernel<T, 1, kRowsWide>;
  kern<<<grid, kThreads, 0, stream>>>(k, x, o, t, d, bins, p.lanes, p.ctiles,
                                      static_cast<int>(blocks), keys_vec,
                                      vals_vec, sc, epoch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The scratch a (t, d) commit needs, in 8-byte words, at most (the plan
// with V = 1 has the most chunks): the ticket, then a word per chunk and
// column.  Zeroed once when allocated.
extern "C" long long colibri_commit_scratch_words(long long t, int d) {
  return 1 + plan_of(t, d, 1).chunks * d;
}

// dtype: 0 = float32, 1 = bfloat16 (vals and out share it).  keys (t,)
// int32 sorted ascending; vals (t, d) and out (bins, d) row-major.
// scratch (n_words): the scratch above, kept from launch to launch on one
// stream; epoch in [1, 2^30): one more than the last launch on this
// scratch (the caller zeroes the scratch when it starts again at 1).
extern "C" int colibri_commit_launch(const void* keys, const void* vals,
                                     void* out, long long t, int d, int bins,
                                     int dtype, void* scratch,
                                     long long n_words, int epoch,
                                     void* stream) {
  if (bins <= 0 || d <= 0 || t < 0 || epoch <= 0 || epoch >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* w = static_cast<unsigned long long*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(keys, vals, out, t, d, bins, w, n_words, epoch, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(keys, vals, out, t, d, bins, w, n_words,
                                 epoch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
