// engine_step.cu — the simulator's engine on Hopper: one cycle's bank side
// (engine_step_kernel) and a whole run in one launch (engine_run_kernel).
//
// Both replace the Pallas kernel src/repro/kernels/engine_step/kernel.py::
// _kernel (launched once per simulated cycle by repro.core.sim.simulate,
// inside the lax.scan that runs the whole run as one device program).
//
// ---- engine_step_kernel: one cycle's bank side --------------------------
//
// Computes the same function as
// src/repro_torch/kernels/engine_step/ref.py::fused_step_ref:
//
//   1. arbitration: for each bank b, the lexicographic minimum of
//      (cand_cyc, rot) over the cores whose addr is b; cand_cyc == BIG
//      means "no request".  The winner's core id is decoded from its rot
//      with a floor-mod, (best_rot - shift) mod n.
//   2. the protocol's bank update (bank_update below: one branch per
//      protocol family, amo, lrsc, and the lrscwait/colibri FIFO queue),
//      emitting an OUT_* code and a response timer per bank.  THE BANK
//      STATE ARRAYS ARE UPDATED IN PLACE.
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
// protocol update.  The bank side of a cycle moves 2-5 KB at the Fig. 3
// sizes, about a nanosecond at 3.35 TB/s, so a launch per cycle is
// launch-bound: the plain loop (core/sim.py::_simulate_plain) keeps it,
// and the engine's own path runs engine_run_kernel instead.
//
// ---- engine_run_kernel: a whole run, one launch --------------------------
//
// Computes what src/repro_torch/core/sim.py::_simulate_plain computes for
// one SimParams: every cycle's core-side stages (timers, issue, retire,
// backoff, Fig. 5 workers, rotating-fair network acceptance), the bank
// side above, the outcome apply, the queue protocols' on_wake, the
// census, the windowed telemetry and the per-cycle traces, bit for bit.
// Hopper's counterpart of the reference's lax.scan is a persistent block:
//
//   * one thread block per run (a batch of runs becomes a grid of blocks);
//     the cycles loop inside the kernel;
//   * per-core state in registers: thread t owns cores t + k * blockDim
//     (k < K, K = 1 up to 1024 cores, 2 up to 2048); above that the
//     state lives in the output arrays in device memory;
//   * per-bank state (the packed arbitration keys, resv_core/resv_valid,
//     qhead/qlen/wake_tmr, addr_ops) in shared memory when it fits,
//     else in a scratch buffer in device memory; qbuf stays in device
//     memory (the output tensor, updated in place);
//   * arbitration: a shared-memory atomicMin of the packed key per bank,
//     double-buffered by cycle parity so a reset never races a read; the
//     core that finds its own key at its bank is the winner and applies
//     the protocol update to that bank itself (one winner per bank);
//   * acceptance: each requester's rank in rotated order is a prefix
//     count of the request bit-mask in core order, split at the core of
//     rotation 0: no sort and no roll;
//   * per-cycle counts go to a shared counter set per cycle parity: a
//     winner adds its outcome with a shared atomic, the census is a warp
//     ballot count per state, the rest is warp-reduced; everyone reads
//     the previous cycle's response load and parked count from it, and
//     thread 0 folds it into the run's totals and the telemetry row
//     during the next cycle's winner phase, off the acceptance's path;
//   * no division in the cycle loop but the head-of-line one: the
//     rotation shift (cyc * 97) mod n is stepped, and rot = (i + shift)
//     mod n is one conditional subtraction; blocks of at most 256
//     threads are compiled with a 256-thread bound, so their state stays
//     in registers.
//
// Barriers per simulated cycle: 4 for the queue protocols (after the
// request words, after the key minimum, after the bank update, after the
// wake flags), 2 for amo and lrsc.
//
// Bound on this card: the work of a cycle is a few hundred instructions
// per thread between those barriers, so the run is bound by its serial
// chain of cycles (the barrier floor, measured by engine_barrier_kernel),
// not by bytes: an untraced run reads and writes tens of KB, a traced
// 256 x 256 run of 5 000 cycles about 11.5 MB (3.4 µs at 3.35 TB/s).
//
// Bit-exactness: int32 counters wrap as torch's do (unsigned adds);
// _hash is a native uint32 multiply; the skew-0 Zipf stream is two
// rounded float32 ops (__fmul_rn, __fadd_rn: no fma contraction), then
// floor, -1 and the clamp, as the port computes it.
//
// Domain: latencies are non-negative (acq_start <= cyc), as the engine
// guarantees; stats[2] starts at 0 and only grows.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 0x7fffffff;
constexpr int kLatBins = 64;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ULL;

// core states (repro_torch.core.protocols.base)
constexpr int kWork = 0, kReq = 1, kSleep = 2, kMod = 3, kBackoff = 4,
              kResp = 5;
// resp_next codes
constexpr int kNxtWorkDone = 0, kNxtMod = 1, kNxtBackoff = 2;
// outcome codes (repro_torch.core.protocols.base.OUT_*)
constexpr int kOutNone = 0, kOutGrant = 1, kOutDone = 2, kOutFail = 3,
              kOutSleep = 4;
// request phases
constexpr int kAcq = 0, kRel = 1;
// protocol families (repro_torch.core.protocols.base.KERNEL_*)
constexpr int kAmo = 0, kLrsc = 1, kQueue = 2;
// address-stream modes (repro_torch.core.workloads.base.ADDR_*)
constexpr int kAddrFixed = 1, kAddrZipf = 2;

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

// int32 arithmetic with torch's wraparound
__device__ __forceinline__ int32_t wadd(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) +
                              static_cast<uint32_t>(y));
}
__device__ __forceinline__ int32_t wsub(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) -
                              static_cast<uint32_t>(y));
}

struct BankState {
  int32_t* resv_core;   // lrsc (a,)
  bool* resv_valid;     // lrsc (a,)
  int32_t* qbuf;        // queue (a, q_cap)
  int32_t* qhead;       // queue (a,)
  int32_t* qlen;        // queue (a,)
  int32_t* wake_tmr;    // queue (a,)
};

// The protocol's update of bank b for this cycle's winner `win` (acq or
// rel: its request phase; neither when the bank has no request).
// Returns the OUT_* code; *extra_msgs gets the protocol's side messages.
__device__ __forceinline__ int bank_update(const BankState& bs, int proto,
                                           int b, int32_t win, bool acq,
                                           bool rel, int q_cap,
                                           int wake_delay, int succ,
                                           int* extra_msgs) {
  int kind = kOutNone;
  *extra_msgs = 0;
  switch (proto) {
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
      const bool empty = ql == 0, full = ql >= q_cap;
      const bool grant = acq && empty;
      const bool enq = acq && !empty && !full;
      const bool rej = acq && full;
      const bool put = acq && !full;
      if (put) {
        const int slot = (qh + ql) % q_cap;
        bs.qbuf[static_cast<long long>(b) * q_cap + slot] = win;
      }
      kind = grant ? kOutGrant
           : enq   ? kOutSleep
           : rej   ? kOutFail
           : rel   ? kOutDone
                   : kOutNone;
      if (rel) qh = (qh + 1) % q_cap;
      ql = ql + (put ? 1 : 0) - (rel ? 1 : 0);
      const bool pend = rel && ql > 0;
      if (pend) bs.wake_tmr[b] = wake_delay;
      bs.qhead[b] = qh;
      bs.qlen[b] = ql;
      if (succ) *extra_msgs = 2 * ((enq ? 1 : 0) + (pend ? 1 : 0));
      break;
    }
    default:
      break;
  }
  return kind;
}

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
    best = min64(best, __shfl_down_sync(kFull, best, off));
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

  // ---- stage 2: the protocol's bank update (in place)
  int extra_msgs;
  const int kind = bank_update(bs, sc.proto, b, win, valid && ph == kAcq,
                               valid && ph == kRel, sc.q_cap, sc.wake_delay,
                               sc.succ, &extra_msgs);
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

// ======================= engine_run_kernel ================================

// per-run scalars, in the order of kernel.RUN_PARAMS (the wrapper packs
// them into an int32 array; zipf_c travels as its float32 bits, seed as
// its uint32 bits)
enum Param {
  P_N, P_A, P_CYCLES, P_PROTO, P_Q_CAP, P_LAT, P_WAKE_DELAY, P_SUCC,
  P_PRE_DUR, P_MOD_DUR, P_ADDR_MODE, P_FIX_ADDR, P_ZIPF_C, P_EXP_CAP,
  P_SEED, P_NET_BW, P_HOL_BLOCK, P_N_WORKERS, P_N_ATOMIC, P_STAGGER,
  P_TRACE, P_TELE_WINDOWS, P_TELE_CW, P_BO_TAB
};
// backoff base by failure streak, streaks >= kBoTab - 1 share the last
// entry (backoff << 32 and beyond is 0)
constexpr int kBoTab = 34;
constexpr int kNumParams = P_BO_TAB + kBoTab;

struct RunParams {
  int n, a, cycles, proto, q_cap, lat, wake_delay, succ, pre_dur, mod_dur,
      addr_mode, fix_addr;
  float zipf_c;
  int exp_cap;
  uint32_t seed;
  int net_bw, hol_block, n_workers, n_atomic, stagger, trace, tele_windows,
      tele_cw;
  int32_t bo_tab[kBoTab];
};

// device pointers, in the order of kernel.RUN_PTRS (null where a key is
// absent: another protocol's bank arrays, telemetry or traces off)
enum Ptr {
  R_ST, R_TMR, R_ADDR, R_PHASE, R_NXT, R_OPC, R_OPS, R_ARR_CYC, R_STREAK,
  R_PARKED, R_ACQ_START, R_W_TMR, R_W_SERVED, R_ADDR_OPS, R_LAT_HIST,
  R_SCALARS, R_RESV_CORE, R_RESV_VALID, R_QBUF, R_QHEAD, R_QLEN,
  R_WAKE_TMR, R_TELE, R_TRACE_STEP, R_TRACE_WAIT, R_TRACE_STATE,
  R_TRACE_QLEN, R_SCRATCH, kNumPtrs
};

struct RunPtrs {
  int32_t *st, *tmr, *addr, *phase, *nxt, *opc, *ops, *arr, *streak;
  bool* parked;
  int32_t *acq, *wtmr, *wserved, *addr_ops, *hist, *scalars;
  int32_t* resv_core;
  bool* resv_valid;
  int32_t *qbuf, *qhead, *qlen, *wake_tmr, *tele, *trace_step, *trace_wait;
  int8_t* trace_state;
  int32_t* trace_qlen;
  unsigned char* scratch;
};

// the run's scalar outputs, in the order of kernel.RUN_SCALARS
enum Scalar {
  S_RESP_PREV, S_MSGS, S_POLLS, S_SLEEP_CYC, S_LAT_MAX, S_ACTIVE_CYC,
  S_BACKOFF_CYC, S_BANK_OPS, S_NET_STALL, kNumScalars
};

// one cycle's counts, one set per cycle parity
enum Count {
  C_NWIN, C_XMSG, C_WAKE_LOAD, C_WACC, C_PARKED, C_FAIL, C_GRANT, C_DONE,
  C_ENQ, C_WAKES, C_SLEEP, C_BACKOFF, C_ACTIVE, C_QSUM, C_QMAX, kNumCounts
};

constexpr int kTeleK = 15;  // obs.schema.TELE_K
constexpr int kRunThreads = 1024;
// dynamic shared memory a block may use beside the static arrays
constexpr size_t kMaxDynSmem = 227 * 1024 - 1024;

// per-bank (and per-core flag) layout, in shared memory or the scratch
struct Layout {
  size_t ints, reqw, bytes, total;
};

__host__ __device__ inline Layout run_layout(int n, int a) {
  Layout L;
  L.ints = 16 * static_cast<size_t>(a);         // keys: 2 x a u64
  L.reqw = L.ints + 20 * static_cast<size_t>(a);  // 5 x a int32
  L.bytes = L.reqw + 4 * static_cast<size_t>((n + 31) / 32);
  L.total = (L.bytes + a + n + 15) & ~static_cast<size_t>(15);
  return L;
}

__device__ __forceinline__ uint32_t hash24(uint32_t x) {
  return (x * 2654435761u) >> 8;  // repro_torch.core.sim._hash
}

// backoff jitter of core i at cycle cyc: _hash(core + cyc) % 32
__device__ __forceinline__ int32_t jitter(uint32_t x) {
  return static_cast<int32_t>(hash24(x) & 31u);
}

// the address of a 24-bit hash h: uniform h % n_addrs, or the skew-0
// Zipf stream floor(u * c + 1) - 1 with u = h / 2^24, each op rounded
__device__ __forceinline__ int32_t addr_of_hash(uint32_t h, int mode,
                                                int n_addrs, float zipf_c) {
  if (mode == kAddrZipf) {
    const float u = __fmul_rn(static_cast<float>(h), 5.9604644775390625e-08f);
    const float x = __fadd_rn(__fmul_rn(u, zipf_c), 1.0f);
    const int32_t v = static_cast<int32_t>(floorf(x)) - 1;
    return min(max(v, 0), n_addrs - 1);
  }
  return static_cast<int32_t>(h % static_cast<uint32_t>(n_addrs));
}

// core.sim's step_addr: the current micro-op's target of core i
__device__ __forceinline__ int32_t step_addr(const RunParams& rp, int i,
                                             int32_t opc) {
  if (rp.addr_mode == kAddrFixed) return rp.fix_addr;
  const uint32_t x = static_cast<uint32_t>(i) * 7919u + rp.seed +
                     static_cast<uint32_t>(opc) * 104729u;
  return addr_of_hash(hash24(x), rp.addr_mode, rp.a, rp.zipf_c);
}

struct Core {
  int32_t st, tmr, addr, phase, nxt, arr, opc, streak, acq, wtmr, wserved;
  bool parked;
};

// the arbitration key of core i, arrived at cycle arr: (arr, rot) packed,
// rot = (i + shift) mod n with i, shift < n
__device__ __forceinline__ unsigned long long packed_key(int32_t arr, int i,
                                                         int shift, int n) {
  const int rot = i + shift < n ? i + shift : i + shift - n;
  return (static_cast<unsigned long long>(static_cast<uint32_t>(arr)) << 32) |
         static_cast<uint32_t>(rot);
}

// per-core state in registers: K cores a thread
template <int K>
struct RegCores {
  Core c[K];
  __device__ __forceinline__ RegCores(const RunPtrs&, int) {}
  static constexpr __device__ int count() { return K; }
  __device__ __forceinline__ Core load(int k, int) const { return c[k]; }
  __device__ __forceinline__ void store(int k, int, const Core& v) {
    c[k] = v;
  }
  static constexpr bool kInRegs = true;
};

// per-core state in the output arrays (more cores than registers hold)
struct GlobalCores {
  RunPtrs o;
  int kc;
  __device__ __forceinline__ GlobalCores(const RunPtrs& p, int k)
      : o(p), kc(k) {}
  __device__ __forceinline__ int count() const { return kc; }
  __device__ __forceinline__ Core load(int, int i) const {
    Core v;
    v.st = o.st[i]; v.tmr = o.tmr[i]; v.addr = o.addr[i];
    v.phase = o.phase[i]; v.nxt = o.nxt[i]; v.arr = o.arr[i];
    v.opc = o.opc[i]; v.streak = o.streak[i]; v.acq = o.acq[i];
    v.wtmr = o.wtmr[i]; v.wserved = o.wserved[i]; v.parked = o.parked[i];
    return v;
  }
  __device__ __forceinline__ void store(int, int i, const Core& v) {
    o.st[i] = v.st; o.tmr[i] = v.tmr; o.addr[i] = v.addr;
    o.phase[i] = v.phase; o.nxt[i] = v.nxt; o.arr[i] = v.arr;
    o.opc[i] = v.opc; o.streak[i] = v.streak; o.acq[i] = v.acq;
    o.wtmr[i] = v.wtmr; o.wserved[i] = v.wserved; o.parked[i] = v.parked;
  }
  static constexpr bool kInRegs = false;
};

// add the warp's count v (the same in every lane) to *dst from lane 0
__device__ __forceinline__ void warp_count(int32_t* dst, int32_t v) {
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(dst, v);
}
// warp-reduce v and add it to *dst (shared memory) from lane 0
__device__ __forceinline__ void warp_add(int32_t* dst, int32_t v) {
  const unsigned s = __reduce_add_sync(kFull, static_cast<unsigned>(v));
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(dst, static_cast<int32_t>(s));
}

template <class Cores, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
engine_run_kernel(RunParams rp, RunPtrs o, int kc, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int32_t s_hist[kLatBins];
  __shared__ int32_t s_cnt[2][kNumCounts];
  __shared__ int32_t s_lat_max;

  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int n = rp.n, a = rp.a, cycles = rp.cycles;
  const bool lrsc = rp.proto == kLrsc, queue = rp.proto == kQueue;
  const bool workers = rp.n_workers > 0, tele = rp.tele_windows > 0;
  const bool trace = rp.trace != 0;

  unsigned char* base = use_smem ? smem_raw : o.scratch;
  const Layout L = run_layout(n, a);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);
  int32_t* ints = reinterpret_cast<int32_t*>(base + L.ints);
  int32_t* addr_ops = ints;
  uint32_t* reqw = reinterpret_cast<uint32_t*>(base + L.reqw);
  bool* resv_valid = reinterpret_cast<bool*>(base + L.bytes);
  unsigned char* woken = base + L.bytes + a;
  BankState bs{ints + a, resv_valid, o.qbuf, ints + 2 * a, ints + 3 * a,
               ints + 4 * a};

  for (int b = tid; b < a; b += T) {
    keys[b] = kNoKey;
    keys[a + b] = kNoKey;
    addr_ops[b] = 0;
    if (lrsc) {
      bs.resv_core[b] = o.resv_core[b];
      bs.resv_valid[b] = o.resv_valid[b];
    }
    if (queue) {
      bs.qhead[b] = o.qhead[b];
      bs.qlen[b] = o.qlen[b];
      bs.wake_tmr[b] = o.wake_tmr[b];
    }
  }
  for (int i = tid; i < n; i += T) woken[i] = 0;
  for (int j = tid; j < kLatBins; j += T) s_hist[j] = 0;
  for (int j = tid; j < 2 * kNumCounts; j += T) (&s_cnt[0][0])[j] = 0;
  if (tid == 0) s_lat_max = 0;

  Cores S(o, kc);
#pragma unroll
  for (int k = 0; k < S.count(); ++k) {
    const int i = tid + k * T;
    if (i < n) {
      Core c;
      c.st = kWork;
      c.tmr = (i * 3) % rp.stagger;
      c.addr = c.phase = c.nxt = c.opc = c.streak = c.acq = 0;
      c.wtmr = c.wserved = 0;
      c.arr = -1;
      c.parked = false;
      S.store(k, i, c);
    }
  }

  // thread 0's run totals (int32, wrapping) and telemetry row
  int32_t msgs = 0, polls = 0, sleep_cyc = 0, backoff_cyc = 0,
          active_cyc = 0, bank_ops = 0, net_stall = 0;
  int32_t stall_now = 0, acc_now = 0, stall_prev = 0, acc_prev = 0;
  int32_t row[kTeleK];
#pragma unroll
  for (int j = 0; j < kTeleK; ++j) row[j] = 0;

  // fold cycle c's counts into the totals (thread 0)
  auto fold = [&](const int32_t* cnt, int c, int32_t stall_c, int32_t acc_c) {
    const int32_t nwin = cnt[C_NWIN];
    const int32_t msgs_now = wadd(wadd(nwin, nwin), cnt[C_XMSG]);
    msgs = wadd(msgs, msgs_now);
    polls = wadd(polls, cnt[C_FAIL]);
    bank_ops = wadd(bank_ops, nwin);
    const int32_t sleep_now = cnt[C_SLEEP], backoff_now = cnt[C_BACKOFF];
    const int32_t active_now =
        workers ? cnt[C_ACTIVE] : wsub(rp.n_atomic, sleep_now);
    sleep_cyc = wadd(sleep_cyc, sleep_now);
    backoff_cyc = wadd(backoff_cyc, backoff_now);
    active_cyc = wadd(active_cyc, active_now);
    if (tele) {
      const int32_t add[kTeleK - 1] = {
          active_now, sleep_now, backoff_now, 0, cnt[C_GRANT], cnt[C_DONE],
          cnt[C_FAIL], cnt[C_ENQ], cnt[C_WAKES], msgs_now, stall_c,
          acc_c, 0, cnt[C_QSUM]};
#pragma unroll
      for (int j = 0; j < kTeleK - 1; ++j) row[j] = wadd(row[j], add[j]);
      row[kTeleK - 1] = max(row[kTeleK - 1], cnt[C_QMAX]);
      if ((c + 1) % rp.tele_cw == 0 || c == cycles - 1) {
        int32_t* dst = o.tele + static_cast<size_t>(c / rp.tele_cw) * kTeleK;
#pragma unroll
        for (int j = 0; j < kTeleK; ++j) {
          dst[j] = row[j];
          row[j] = 0;
        }
      }
    }
  };
  __syncthreads();

  const int nw = (n + 31) >> 5;
  // the rotation shift (cyc * 97) mod n, stepped without a division
  const int shift_step = 97 % n;
  int shift = 0;
  for (int cyc = 0; cyc < cycles; ++cyc) {
    const int par = cyc & 1;
    const int32_t* prev = s_cnt[par ^ 1];
    int32_t* cur = s_cnt[par];
    unsigned long long* key_now = keys + par * a;
    if (cyc > 0) {
      shift += shift_step;
      if (shift >= n) shift -= n;
    }

    // ---- timers, issue, retire, backoff, workers; the request words
#pragma unroll
    for (int k = 0; k < S.count(); ++k) {
      const int i = tid + k * T;
      bool req = false;
      if (i < n) {
        Core c = S.load(k, i);
        const bool worker = workers && i < rp.n_workers;
        c.tmr = max(c.tmr - 1, 0);
        const bool t0 = c.tmr == 0;
        const bool start = t0 && c.st == kWork && !worker;
        const bool rb = t0 && c.st == kBackoff;
        const bool md = t0 && c.st == kMod;
        if (start) {
          c.addr = step_addr(rp, i, c.opc);
          c.acq = cyc;
        }
        if (start || rb) c.phase = kAcq;
        if (md) c.phase = kRel;
        if (start || rb || md) {
          c.st = kReq;
          c.tmr = rp.lat;
        }
        const bool ra = t0 && c.st == kResp;
        const bool done = ra && c.nxt == kNxtWorkDone;
        if (done) {
          c.st = kWork;
          c.tmr = rp.pre_dur;
          c.opc = wadd(c.opc, 1);
          c.streak = 0;
          atomicAdd(&addr_ops[c.addr], 1);
        }
        if (ra && c.nxt == kNxtMod) {
          c.st = kMod;
          c.tmr = rp.mod_dur;
        }
        if (ra && c.nxt == kNxtBackoff) {
          c.st = kBackoff;
          c.streak = min(c.streak + 1, rp.exp_cap);
          c.tmr = wadd(rp.bo_tab[min(c.streak, kBoTab - 1)],
                       jitter(static_cast<uint32_t>(cyc + i)));
        }
        if (trace) {
          const size_t at = static_cast<size_t>(cyc) * n + i;
          o.trace_wait[at] = done ? cyc - c.acq : -1;
          o.trace_step[at] = done ? 0 : -1;
        }
        if (workers) c.wtmr = max(c.wtmr - 1, 0);
        const bool fresh = c.st == kReq && c.tmr == 0 && !c.parked && !worker;
        req = fresh || (worker && c.wtmr == 0);
        S.store(k, i, c);
      }
      const unsigned word = __ballot_sync(kFull, req);
      const int w = k * (T >> 5) + wid;
      if (lane == 0 && w < nw) reqw[w] = word;
    }
    __syncthreads();  // 1: request words

    // the previous cycle's response load and parked count set the budget
    const int32_t resp_prev = wadd(wadd(prev[C_NWIN], prev[C_XMSG]),
                                   wadd(prev[C_WAKE_LOAD], prev[C_WACC]));
    const int32_t hol = rp.hol_block ? prev[C_PARKED] / rp.hol_block : 0;
    const int32_t budget = max(wsub(wsub(rp.net_bw, resp_prev), hol), 1);
    for (int b = tid; b < a; b += T) keys[(par ^ 1) * a + b] = kNoKey;

    // rank of core i among requesters in rotated order (rot = (i + shift)
    // mod n starts at core j0): prefix counts P(x) of the request mask
    // over cores [0, x), split at j0
    const int j0 = shift == 0 ? 0 : n - shift;
    int32_t tot = 0, pj0 = 0;
    for (int w = lane; w < nw; w += 32) {
      const int c = __popc(reqw[w]);
      tot += c;
      if (w < (j0 >> 5)) pj0 += c;
    }
    tot = static_cast<int32_t>(__reduce_add_sync(kFull, tot));
    pj0 = static_cast<int32_t>(__reduce_add_sync(kFull, pj0)) +
          __popc(reqw[j0 >> 5] & ((1u << (j0 & 31)) - 1u));
    const int32_t acc_cnt = min(tot, budget);
    if (tid == 0) {
      stall_prev = stall_now;
      acc_prev = acc_now;
      stall_now = tot - acc_cnt;
      acc_now = acc_cnt;
      net_stall = wadd(net_stall, stall_now);
    }

    int32_t l_wacc = 0;
#pragma unroll
    for (int k = 0; k < S.count(); ++k) {
      const int i = tid + k * T;
      const int wk = k * (T >> 5) + wid;  // this warp's word (uniform)
      int32_t pre = 0;
      for (int w = lane; w < wk; w += 32) pre += __popc(reqw[w]);
      pre = static_cast<int32_t>(__reduce_add_sync(kFull, pre));
      if (i < n) {
        Core c = S.load(k, i);
        const bool worker = workers && i < rp.n_workers;
        const bool fresh = c.st == kReq && c.tmr == 0 && !c.parked && !worker;
        const bool w_arr = worker && c.wtmr == 0;
        bool acc = false;
        if (fresh || w_arr) {
          const int32_t pi1 =
              pre + __popc(reqw[wk] & ((2u << (i & 31)) - 1u));  // P(i + 1)
          const int32_t r1 = i >= j0 ? pi1 - pj0 : tot - pj0 + pi1;
          acc = r1 - 1 < budget;
        }
        if (workers) {
          const bool w_acc = w_arr && acc;
          if (w_acc) {
            c.wserved = wadd(c.wserved, 1);
            c.wtmr = 2;
            ++l_wacc;
          }
          if (worker && c.wtmr == 0) c.wtmr = 1;
        }
        if (fresh && acc) {
          c.parked = true;
          c.arr = cyc;
        }
        if (c.parked && c.st == kReq) {
          const unsigned long long key = packed_key(c.arr, i, shift, n);
          atomicMin(&key_now[c.addr], key);
        }
        S.store(k, i, c);
      }
    }
    __syncthreads();  // 2: the key minimum of every bank

    // thread 0 folds the previous cycle's counts (read by everyone
    // before barrier 2) and clears them for the next cycle
    if (tid == 0) {
      if (cyc > 0) fold(prev, cyc - 1, stall_prev, acc_prev);
#pragma unroll
      for (int j = 0; j < kNumCounts; ++j) s_cnt[par ^ 1][j] = 0;
    }
    // ---- winners: the protocol's bank update and the outcome apply
#pragma unroll
    for (int k = 0; k < S.count(); ++k) {
      const int i = tid + k * T;
      if (i < n) {
        Core c = S.load(k, i);
        if (c.parked && c.st == kReq) {
          const unsigned long long key = packed_key(c.arr, i, shift, n);
          if (key_now[c.addr] == key) {
            int xm;
            const int kind = bank_update(bs, rp.proto, c.addr, i,
                                         c.phase == kAcq, c.phase == kRel,
                                         rp.q_cap, rp.wake_delay, rp.succ,
                                         &xm);
            const int32_t done_cyc = cyc + max(rp.lat, 1);
            if (kind == kOutDone && done_cyc < cycles) {
              const int32_t lat_b = done_cyc - c.acq;
              atomicAdd(&s_hist[lat_bucket(lat_b)], 1);
              atomicMax(&s_lat_max, lat_b);
            }
            atomicAdd(&cur[C_NWIN], 1);
            if (xm) atomicAdd(&cur[C_XMSG], xm);
            if (kind == kOutFail) atomicAdd(&cur[C_FAIL], 1);
            if (tele) {
              if (kind == kOutGrant) atomicAdd(&cur[C_GRANT], 1);
              if (kind == kOutDone) atomicAdd(&cur[C_DONE], 1);
              if (kind == kOutSleep) atomicAdd(&cur[C_ENQ], 1);
            }
            c.parked = false;
            c.arr = -1;
            if (kind == kOutGrant || kind == kOutDone || kind == kOutFail) {
              c.st = kResp;
              c.tmr = rp.lat;
              c.nxt = kind == kOutGrant  ? kNxtMod
                    : kind == kOutDone   ? kNxtWorkDone
                                         : kNxtBackoff;
            } else if (kind == kOutSleep) {
              c.st = kSleep;
            }
            S.store(k, i, c);
          }
        }
      }
    }
    if (queue) __syncthreads();  // 3: the bank updates

    // ---- banks: on_wake, queue depths (after the update)
    int32_t l_qsum = 0, l_qmax = 0;
    for (int b = tid; (queue || trace) && b < a; b += T) {
      int32_t ql = 0;
      if (queue) {
        const int32_t wt = bs.wake_tmr[b];
        const int32_t wt2 = max(wt - 1, 0);
        bs.wake_tmr[b] = wt2;
        ql = bs.qlen[b];
        if (wt == 1 && ql > 0) {
          const int32_t head =
              o.qbuf[static_cast<size_t>(b) * rp.q_cap + bs.qhead[b]];
          if (head >= 0 && head < n) woken[head] = 1;
        }
        if (wt2 == 1) atomicAdd(&cur[C_WAKE_LOAD], 1);
      }
      l_qsum = wadd(l_qsum, ql);
      l_qmax = max(l_qmax, ql);
      if (trace) o.trace_qlen[static_cast<size_t>(cyc) * a + b] = ql;
    }
    if (queue) __syncthreads();  // 4: the wake flags

    // ---- wakes, census, trace state
    int32_t l_wakes = 0, l_sleep = 0, l_backoff = 0, l_active = 0,
            l_parked = 0;
#pragma unroll
    for (int k = 0; k < S.count(); ++k) {
      const int i = tid + k * T;
      bool sl = false, bo = false, ac = false, pk = false;
      if (i < n) {
        Core c = S.load(k, i);
        if (queue && woken[i]) {
          woken[i] = 0;
          l_wakes += c.st == kSleep;
          c.st = kMod;
          c.tmr = rp.mod_dur;
          S.store(k, i, c);
        }
        sl = c.st == kSleep;
        bo = c.st == kBackoff;
        ac = c.st != kSleep && !(workers && i < rp.n_workers);
        pk = c.parked;
        if (trace) {
          o.trace_state[static_cast<size_t>(cyc) * n + i] =
              static_cast<int8_t>(c.st);
        }
      }
      l_sleep += __popc(__ballot_sync(kFull, sl));
      l_backoff += __popc(__ballot_sync(kFull, bo));
      if (workers) l_active += __popc(__ballot_sync(kFull, ac));
      if (rp.hol_block) l_parked += __popc(__ballot_sync(kFull, pk));
    }
    warp_count(&cur[C_SLEEP], l_sleep);
    warp_count(&cur[C_BACKOFF], l_backoff);
    if (workers) {
      warp_add(&cur[C_WACC], l_wacc);
      warp_count(&cur[C_ACTIVE], l_active);
    }
    if (rp.hol_block) warp_count(&cur[C_PARKED], l_parked);
    if (tele) {
      warp_add(&cur[C_WAKES], l_wakes);
      warp_add(&cur[C_QSUM], l_qsum);
      const unsigned m =
          __reduce_max_sync(kFull, static_cast<unsigned>(l_qmax));
      if (lane == 0) atomicMax(&cur[C_QMAX], static_cast<int32_t>(m));
    }
  }
  __syncthreads();

  // ---- the run's outputs
  if (tid == 0) {
    const int32_t* last = s_cnt[(cycles - 1) & 1];
    fold(last, cycles - 1, stall_now, acc_now);
    o.scalars[S_RESP_PREV] = wadd(wadd(last[C_NWIN], last[C_XMSG]),
                                  wadd(last[C_WAKE_LOAD], last[C_WACC]));
    o.scalars[S_MSGS] = msgs;
    o.scalars[S_POLLS] = polls;
    o.scalars[S_SLEEP_CYC] = sleep_cyc;
    o.scalars[S_LAT_MAX] = s_lat_max;
    o.scalars[S_ACTIVE_CYC] = active_cyc;
    o.scalars[S_BACKOFF_CYC] = backoff_cyc;
    o.scalars[S_BANK_OPS] = bank_ops;
    o.scalars[S_NET_STALL] = net_stall;
  }
  for (int j = tid; j < kLatBins; j += T) o.hist[j] = s_hist[j];
  for (int b = tid; b < a; b += T) {
    o.addr_ops[b] = addr_ops[b];
    if (lrsc) {
      o.resv_core[b] = bs.resv_core[b];
      o.resv_valid[b] = bs.resv_valid[b];
    }
    if (queue) {
      o.qhead[b] = bs.qhead[b];
      o.qlen[b] = bs.qlen[b];
      o.wake_tmr[b] = bs.wake_tmr[b];
    }
  }
#pragma unroll
  for (int k = 0; k < S.count(); ++k) {
    const int i = tid + k * T;
    if (i < n) {
      const Core c = S.load(k, i);
      if (Cores::kInRegs) {
        o.st[i] = c.st; o.tmr[i] = c.tmr; o.addr[i] = c.addr;
        o.phase[i] = c.phase; o.nxt[i] = c.nxt; o.arr[i] = c.arr;
        o.opc[i] = c.opc; o.streak[i] = c.streak; o.acq[i] = c.acq;
        o.wtmr[i] = c.wtmr; o.wserved[i] = c.wserved;
        o.parked[i] = c.parked;
      }
      o.ops[i] = c.opc;
    }
  }
}

// step_addr / jitter / _hash on given inputs, for the exactness check
__global__ void engine_probe_kernel(const uint32_t* __restrict__ x,
                                    long long count, int what, int mode,
                                    int n_addrs, float zipf_c,
                                    int32_t* __restrict__ out) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < count; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint32_t v = x[j];
    out[j] = what == 0   ? static_cast<int32_t>(hash24(v))
           : what == 1   ? jitter(v)
                         : addr_of_hash(v, mode, n_addrs, zipf_c);
  }
}

// the serial floor: `per_cycle` block barriers a cycle and no other work
__global__ void engine_barrier_kernel(int cycles, int per_cycle,
                                      int32_t* sink) {
  __shared__ int32_t s;
  if (threadIdx.x == 0) s = 0;
  __syncthreads();
  for (int cyc = 0; cyc < cycles; ++cyc) {
    for (int j = 0; j < per_cycle; ++j) __syncthreads();
    if (threadIdx.x == 0) s += 1;
  }
  if (threadIdx.x == 0) sink[0] = s;
}

template <class Cores, int kMaxThreads>
cudaError_t launch_run(const RunParams& rp, const RunPtrs& o, int threads,
                       int kc, size_t smem, cudaStream_t stream) {
  auto kern = engine_run_kernel<Cores, kMaxThreads>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<1, threads, smem, stream>>>(rp, o, kc, smem > 0 ? 1 : 0);
  return cudaGetLastError();
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

// Bytes of device scratch a run of n cores and a banks needs: 0 when its
// per-bank state fits in shared memory.
extern "C" long long engine_run_scratch_bytes(int n, int a) {
  const size_t total = run_layout(n, a).total;
  return total <= kMaxDynSmem ? 0 : static_cast<long long>(total);
}

// Threads per block of a run of n cores (the barrier floor's block size).
extern "C" int engine_run_threads(int n) {
  return n <= kRunThreads ? ((n + 31) / 32) * 32 : kRunThreads;
}

// One launch for a whole run.  `params` holds kNumParams int32 values,
// `ptrs` kNumPtrs device pointers.  Returns a CUDA error code, or -1 when
// the caller's layout does not match this library's.
extern "C" int engine_run_launch(const int32_t* params, int n_params,
                                 void* const* ptrs, int n_ptrs,
                                 void* stream) {
  if (n_params != kNumParams || n_ptrs != kNumPtrs) return -1;
  RunParams rp;
  rp.n = params[P_N];
  rp.a = params[P_A];
  rp.cycles = params[P_CYCLES];
  rp.proto = params[P_PROTO];
  rp.q_cap = params[P_Q_CAP];
  rp.lat = params[P_LAT];
  rp.wake_delay = params[P_WAKE_DELAY];
  rp.succ = params[P_SUCC];
  rp.pre_dur = params[P_PRE_DUR];
  rp.mod_dur = params[P_MOD_DUR];
  rp.addr_mode = params[P_ADDR_MODE];
  rp.fix_addr = params[P_FIX_ADDR];
  const int32_t zc = params[P_ZIPF_C];
  static_assert(sizeof(float) == sizeof(int32_t), "float bits");
  std::memcpy(&rp.zipf_c, &zc, sizeof(float));
  rp.exp_cap = params[P_EXP_CAP];
  rp.seed = static_cast<uint32_t>(params[P_SEED]);
  rp.net_bw = params[P_NET_BW];
  rp.hol_block = params[P_HOL_BLOCK];
  rp.n_workers = params[P_N_WORKERS];
  rp.n_atomic = params[P_N_ATOMIC];
  rp.stagger = params[P_STAGGER];
  rp.trace = params[P_TRACE];
  rp.tele_windows = params[P_TELE_WINDOWS];
  rp.tele_cw = params[P_TELE_CW];
  for (int j = 0; j < kBoTab; ++j) rp.bo_tab[j] = params[P_BO_TAB + j];

  RunPtrs o;
  o.st = static_cast<int32_t*>(ptrs[R_ST]);
  o.tmr = static_cast<int32_t*>(ptrs[R_TMR]);
  o.addr = static_cast<int32_t*>(ptrs[R_ADDR]);
  o.phase = static_cast<int32_t*>(ptrs[R_PHASE]);
  o.nxt = static_cast<int32_t*>(ptrs[R_NXT]);
  o.opc = static_cast<int32_t*>(ptrs[R_OPC]);
  o.ops = static_cast<int32_t*>(ptrs[R_OPS]);
  o.arr = static_cast<int32_t*>(ptrs[R_ARR_CYC]);
  o.streak = static_cast<int32_t*>(ptrs[R_STREAK]);
  o.parked = static_cast<bool*>(ptrs[R_PARKED]);
  o.acq = static_cast<int32_t*>(ptrs[R_ACQ_START]);
  o.wtmr = static_cast<int32_t*>(ptrs[R_W_TMR]);
  o.wserved = static_cast<int32_t*>(ptrs[R_W_SERVED]);
  o.addr_ops = static_cast<int32_t*>(ptrs[R_ADDR_OPS]);
  o.hist = static_cast<int32_t*>(ptrs[R_LAT_HIST]);
  o.scalars = static_cast<int32_t*>(ptrs[R_SCALARS]);
  o.resv_core = static_cast<int32_t*>(ptrs[R_RESV_CORE]);
  o.resv_valid = static_cast<bool*>(ptrs[R_RESV_VALID]);
  o.qbuf = static_cast<int32_t*>(ptrs[R_QBUF]);
  o.qhead = static_cast<int32_t*>(ptrs[R_QHEAD]);
  o.qlen = static_cast<int32_t*>(ptrs[R_QLEN]);
  o.wake_tmr = static_cast<int32_t*>(ptrs[R_WAKE_TMR]);
  o.tele = static_cast<int32_t*>(ptrs[R_TELE]);
  o.trace_step = static_cast<int32_t*>(ptrs[R_TRACE_STEP]);
  o.trace_wait = static_cast<int32_t*>(ptrs[R_TRACE_WAIT]);
  o.trace_state = static_cast<int8_t*>(ptrs[R_TRACE_STATE]);
  o.trace_qlen = static_cast<int32_t*>(ptrs[R_TRACE_QLEN]);
  o.scratch = static_cast<unsigned char*>(ptrs[R_SCRATCH]);

  const size_t total = run_layout(rp.n, rp.a).total;
  const size_t smem = total <= kMaxDynSmem ? total : 0;
  if (smem == 0 && o.scratch == nullptr) return -1;
  const int threads = engine_run_threads(rp.n);
  const int kc = (rp.n + threads - 1) / threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a block of at most 256 threads may use up to 255 registers a thread
  cudaError_t err;
  if (kc > 2) {
    err = launch_run<GlobalCores, kRunThreads>(rp, o, threads, kc, smem, s);
  } else if (kc == 2) {
    err = launch_run<RegCores<2>, kRunThreads>(rp, o, threads, kc, smem, s);
  } else if (threads <= 256) {
    err = launch_run<RegCores<1>, 256>(rp, o, threads, kc, smem, s);
  } else {
    err = launch_run<RegCores<1>, kRunThreads>(rp, o, threads, kc, smem, s);
  }
  return static_cast<int>(err);
}

// what: 0 -> _hash(x), 1 -> the backoff jitter _hash(x) % 32, 2 -> the
// address of hash x in address mode `mode` over n_addrs (skew-0 factor
// zipf_c).  x and out are device arrays of `count` elements.
extern "C" int engine_probe_launch(const void* x, long long count, int what,
                                   int mode, int n_addrs, float zipf_c,
                                   void* out, void* stream) {
  engine_probe_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), count, what, mode, n_addrs, zipf_c,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// `cycles` cycles of `per_cycle` barriers in one block of `threads`.
extern "C" int engine_barrier_launch(int threads, int cycles, int per_cycle,
                                     void* sink, void* stream) {
  engine_barrier_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      cycles, per_cycle, static_cast<int32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
