// engine_step.cu — one simulated cycle's bank side, fused, for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/engine_step/kernel.py::_kernel
// (launched once per simulated cycle by repro.core.sim.simulate).  It
// computes the same function as
// src/repro_torch/kernels/engine_step/ref.py::fused_step_ref:
//
//   1. arbitration: for each bank b, the lexicographic minimum of
//      (cand_cyc, rot) over the cores whose addr is b; cand_cyc == BIG
//      means "no request".  The winner's core id is decoded from its rot
//      with a floor-mod, (best_rot - shift) mod n.
//   2. the protocol's bank update (one branch per protocol family:
//      amo, lrsc, and the lrscwait/colibri FIFO queue), emitting an
//      OUT_* code and a response timer per bank.  THE BANK STATE ARRAYS
//      ARE UPDATED IN PLACE.
//   3. the completion-latency histogram of the retiring grants, bucketed
//      with the integer LAT_THRESHOLDS table (no floating-point log2),
//      and the [polls, msgs, lat_max] stats, accumulated with integer
//      atomics (exact and independent of order).  The caller zeroes
//      `stats` and `hist` before the launch.
//
// Design: one thread block per bank.  The block's threads stride over the
// n cores and reduce one packed int64 key (int64(cand) << 32) | rot, whose
// minimum is the lexicographic (cand, rot) minimum; the packing cannot
// overflow (cand and rot are int32 >= 0).  Thread 0 then applies the
// protocol update.  The work is O(a*n) per cycle, like the Pallas tile
// loop.
//
// Bound on this card: bytes.  The function must read cand and addr
// (8n bytes; rot is (i + shift) mod n, derivable from shift, though this
// kernel reads it: 4n more), and at each bank with a request the
// winner's phase and acq_start and that bank's state lanes (8 + up to 8
// bytes); it writes four (a,) outputs (13a bytes), the bank-state
// elements that change and 67 stat words.  That is about 8n + 13a + 16
// per requested bank, 2-5 KB at the Fig. 3 sizes (n = 256, a = 1..256),
// i.e. around a nanosecond at 3.35 TB/s.  At those sizes the launch
// itself (microseconds) dominates: the kernel is launch-bound, and the
// next step is to cut launches (a persistent kernel over many cycles,
// or CUDA graphs), not bytes.
//
// Domain: latencies are non-negative (acq_start <= cyc), as the engine
// guarantees; stats[2] starts at 0 and only grows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 0x7fffffff;
constexpr int kLatBins = 64;
constexpr int kThreads = 256;

// outcome codes (repro_torch.core.protocols.base.OUT_*)
constexpr int kOutNone = 0, kOutGrant = 1, kOutDone = 2, kOutFail = 3,
              kOutSleep = 4;
// request phases
constexpr int kAcq = 0, kRel = 1;
// protocol families (repro_torch.core.protocols.base.KERNEL_*)
constexpr int kAmo = 0, kLrsc = 1, kQueue = 2;

// smallest latency of each histogram bucket (core.metrics.LAT_THRESHOLDS)
__constant__ int32_t kLatThr[kLatBins] = {
    0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 5, 6, 7, 9, 11, 13,
    15, 19, 22, 26, 31, 38, 45, 53, 63, 76, 90, 107, 127, 152, 181, 215,
    255, 304, 362, 430, 511, 608, 724, 861, 1023, 1217, 1448, 1722, 2047,
    2435, 2896, 3444, 4095, 4870, 5792, 6888, 8192, 9741, 11585, 13777,
    16383, 19483, 23170, 27554, 32768, 38967, 46340, 55108};

__device__ int lat_bucket(int32_t v) {
  int k = 0;  // largest k with kLatThr[k] <= v; 0 below the first
  for (int i = 1; i < kLatBins; ++i) {
    if (kLatThr[i] <= v) k = i;
  }
  return k;
}

__device__ __forceinline__ long long min64(long long x, long long y) {
  return x < y ? x : y;
}

struct BankState {
  int32_t* resv_core;   // lrsc (a,)
  bool* resv_valid;     // lrsc (a,)
  int32_t* qbuf;        // queue (a, q_cap)
  int32_t* qhead;       // queue (a,)
  int32_t* qlen;        // queue (a,)
  int32_t* wake_tmr;    // queue (a,)
};

struct Scalars {
  int n, proto, q_cap, cyc, shift, lat, wake_delay, succ, cycles;
};

__global__ void __launch_bounds__(kThreads)
engine_step_kernel(const int32_t* __restrict__ cand,
                   const int32_t* __restrict__ rot,
                   const int32_t* __restrict__ addr,
                   const int32_t* __restrict__ phase,
                   const int32_t* __restrict__ acq_start,
                   BankState bs, bool* valid_out, int32_t* win_out,
                   int32_t* kind_out, int32_t* tmr_out, int32_t* stats,
                   int32_t* hist, Scalars sc) {
  const int b = blockIdx.x;
  const int n = sc.n;

  // ---- stage 1: packed (cand, rot) key, block-wide min
  long long best = (static_cast<long long>(kBig) << 32) | kBig;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (addr[i] == b) {
      long long key = (static_cast<long long>(cand[i]) << 32) |
                      static_cast<uint32_t>(rot[i]);
      best = min64(best, key);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    best = min64(best, __shfl_down_sync(0xffffffffu, best, off));
  }
  __shared__ long long warp_best[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_best[wid] = best;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (blockDim.x + 31) / 32; ++w) {
    best = min64(best, warp_best[w]);
  }

  const int32_t best_cyc = static_cast<int32_t>(best >> 32);
  const int32_t best_rot = static_cast<int32_t>(best & 0xffffffffLL);
  const bool valid = best_cyc != kBig;
  // floor-mod: C's % truncates toward zero
  const int32_t win = valid ? (((best_rot - sc.shift) % n) + n) % n : n;
  const int wcs = win < n - 1 ? win : n - 1;
  const int32_t ph = phase[wcs];
  const bool acq = valid && ph == kAcq;
  const bool rel = valid && ph == kRel;

  // ---- stage 2: the protocol's bank update (in place)
  int kind = kOutNone;
  int extra_msgs = 0;
  switch (sc.proto) {
    case kAmo:
      kind = acq ? kOutDone : kOutNone;
      break;
    case kLrsc: {
      int32_t rc = bs.resv_core[b];
      const bool rv = bs.resv_valid[b];
      const bool got = acq && !rv;
      if (got) rc = win;
      const bool owner = rel && rv && rc == win;
      bs.resv_core[b] = rc;
      bs.resv_valid[b] = (rv || got) && !owner;
      kind = acq ? kOutGrant : owner ? kOutDone : rel ? kOutFail : kOutNone;
      break;
    }
    case kQueue: {
      int32_t qh = bs.qhead[b], ql = bs.qlen[b];
      const bool empty = ql == 0, full = ql >= sc.q_cap;
      const bool grant = acq && empty;
      const bool enq = acq && !empty && !full;
      const bool rej = acq && full;
      const bool put = acq && !full;
      if (put) {
        const int slot = (qh + ql) % sc.q_cap;
        bs.qbuf[static_cast<long long>(b) * sc.q_cap + slot] = win;
      }
      kind = grant ? kOutGrant
           : enq   ? kOutSleep
           : rej   ? kOutFail
           : rel   ? kOutDone
                   : kOutNone;
      if (rel) qh = (qh + 1) % sc.q_cap;
      ql = ql + (put ? 1 : 0) - (rel ? 1 : 0);
      const bool pend = rel && ql > 0;
      if (pend) bs.wake_tmr[b] = sc.wake_delay;
      bs.qhead[b] = qh;
      bs.qlen[b] = ql;
      if (sc.succ) extra_msgs = 2 * ((enq ? 1 : 0) + (pend ? 1 : 0));
      break;
    }
    default:
      break;
  }
  const int32_t tmr = sc.lat;
  valid_out[b] = valid;
  win_out[b] = win;
  kind_out[b] = kind;
  tmr_out[b] = tmr;

  // ---- stage 3: latency histogram and stats
  const int32_t done_cyc = sc.cyc + (tmr > 1 ? tmr : 1);
  if (kind == kOutDone && done_cyc < sc.cycles) {
    const int32_t lat_b = done_cyc - acq_start[wcs];
    atomicAdd(&hist[lat_bucket(lat_b)], 1);
    atomicMax(&stats[2], lat_b);
  }
  if (kind == kOutFail) atomicAdd(&stats[0], 1);
  if (extra_msgs) atomicAdd(&stats[1], extra_msgs);
}

}  // namespace

extern "C" int engine_step_launch(
    const void* cand, const void* rot, const void* addr, const void* phase,
    const void* acq_start, void* resv_core, void* resv_valid, void* qbuf,
    void* qhead, void* qlen, void* wake_tmr, void* valid_out, void* win_out,
    void* kind_out, void* tmr_out, void* stats, void* hist, int n, int a,
    int proto, int q_cap, int cyc, int shift, int lat, int wake_delay,
    int succ, int cycles, void* stream) {
  BankState bs{static_cast<int32_t*>(resv_core),
               static_cast<bool*>(resv_valid), static_cast<int32_t*>(qbuf),
               static_cast<int32_t*>(qhead), static_cast<int32_t*>(qlen),
               static_cast<int32_t*>(wake_tmr)};
  Scalars sc{n, proto, q_cap, cyc, shift, lat, wake_delay, succ, cycles};
  engine_step_kernel<<<a, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), static_cast<const int32_t*>(rot),
      static_cast<const int32_t*>(addr), static_cast<const int32_t*>(phase),
      static_cast<const int32_t*>(acq_start), bs,
      static_cast<bool*>(valid_out), static_cast<int32_t*>(win_out),
      static_cast<int32_t*>(kind_out), static_cast<int32_t*>(tmr_out),
      static_cast<int32_t*>(stats), static_cast<int32_t*>(hist), sc);
  return static_cast<int>(cudaGetLastError());
}
