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
//      protocol family: amo; lrsc's reservation slot; the FIFO queue of
//      lrscwait, colibri and mwait_lock, and of nb_feb behind its
//      full/empty bit; the test&set lock bit of amo_lock and lrsc_lock;
//      ticket_lock's dispenser, which reads the winner's held ticket and
//      writes it back; the two-level queues of colibri_hier and
//      hw_event: group-local FIFOs under a global FIFO of groups),
//      emitting an OUT_* code,
//      the outcome's response timer and the per-core write (value, mask)
//      per bank.  THE BANK STATE ARRAYS ARE UPDATED IN PLACE.
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
// one SimParams: every cycle's core-side stages (timers, issue, retire
// with the workload program's step tables, backoff, the barrier release,
// Fig. 5 workers, rotating-fair network acceptance), the bank side above,
// the outcome apply, the queue protocols' on_wake, the census, the
// windowed telemetry and the per-cycle traces, bit for bit.
// Hopper's counterpart of the reference's lax.scan is a persistent block:
//
//   * one thread block per run, the cycles looping inside the kernel; a
//     batch of runs of one core count (core/sweep.py's launch group) is
//     a grid of such blocks, one launch.  Block b stages its own run's
//     parameter words and output pointers in shared memory once (blocks
//     of at most 256 threads copy the scalars on into registers);
//     nothing is shared between blocks but the read-only kLatThr table,
//     so the blocks may run in any order;
//   * per-core state (ticket_lock's held ticket too) in registers: thread
//     t owns cores t + k * blockDim
//     (k < K, K = 1 up to 1024 cores, 2 up to 2048); above that the
//     state lives in the output arrays in device memory;
//   * per-bank state (the packed arbitration keys, the family's bank
//     arrays: resv_core/resv_valid, qhead/qlen/wake_tmr, lock, next_tkt/
//     serving, feb, the two-level queues' cur_grp/gqhead/wake_tmr and
//     queue depth; addr_ops) in shared memory when it fits, else in a
//     scratch buffer in device memory; qbuf, and the two-level queues'
//     local queues, global FIFOs of groups and their other per-bank words,
//     stay in device memory (the output tensors, updated in place).  The
//     families share their slots, so the footprint is the same for all of
//     them;
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
//   * workload programs of more than one step or with a barrier step
//     run on an instance of their own (kProg, see engine_run_kernel),
//     which derives the program counter, ops and barrier arrivals from
//     the op count and the step tables (parameter words in shared
//     memory) and adds no barrier a cycle; the other instances have the
//     program code compiled out;
//   * a launch that holds a run on a hierarchical topology (cluster2,
//     cluster3) runs on the topology instance (kTopo, with the wide
//     families' and the program code), which bills the
//     crossed levels' latency at issue and ranks each level's requesters
//     in the acceptance pass from their own request words, with no
//     barrier more a cycle.
//
// Barriers per simulated cycle: 4 for the queue protocols, one FIFO or
// two levels (after the request words, after the key minimum, after the
// bank update, after the wake flags), 2 for amo, lrsc and the spin locks.
//
// Bound on this card: the work of a cycle is a few hundred instructions
// per thread between those barriers, so the run is bound by its serial
// chain of cycles (the barrier floor, measured by engine_barrier_kernel),
// not by bytes: an untraced run reads and writes tens of KB, a traced
// 256 x 256 run of 5 000 cycles about 11.5 MB (3.4 µs at 3.35 TB/s).
//
// A batch allocates each run's banks at the power-of-two bucket of its
// address count (core/sim.py::_bucket_a) and hashes addresses over the
// live count (RunParams.n_addrs), as the reference's sweep does: the
// padded banks see no request and keep their initial state.  A single
// run has n_addrs == a.
//
// Bit-exactness: int32 counters wrap as torch's do (unsigned adds);
// _hash is a native uint32 multiply; the skew-0 Zipf stream is
// fma(u, c, 1) with one rounding (__fmaf_rn), then floor, -1 and the
// clamp, as the reference's contracted 1 + u * c; a skewed stream is a
// count of host-built thresholds (no float pow on the card).  A
// hierarchical topology (the topology instance) derives each (core,
// bank) path's crossed levels from the two clusters, its extra latency
// and hop count from the level words.
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
              kResp = 5, kBarWait = 6;
// resp_next codes
constexpr int kNxtWorkDone = 0, kNxtMod = 1, kNxtBackoff = 2;
// outcome codes (repro_torch.core.protocols.base.OUT_*)
constexpr int kOutNone = 0, kOutGrant = 1, kOutDone = 2, kOutFail = 3,
              kOutSleep = 4;
// the watchdog's recovery codes (OUT_EVICT, OUT_REDELIVER)
constexpr int kOutEvict = 5, kOutRedeliver = 6;
// request phases
constexpr int kAcq = 0, kRel = 1;
// protocol families (repro_torch.core.protocols.base.KERNEL_*)
constexpr int kAmo = 0, kLrsc = 1, kQueue = 2, kLock = 3, kTicket = 4,
              kHier = 5, kEvent = 6, kFeb = 7;
// side-message rules (repro_torch.core.protocols.base.MSGS_*)
constexpr int kMsgsNone = 0, kMsgsEnqPend = 1, kMsgsEnq = 2, kMsgsAcq = 3,
              kMsgsHier = 4, kMsgsEvent = 5;
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
  int32_t* qbuf;        // queue, feb (a, q_cap)
  int32_t* qhead;       // queue, feb (a,)
  int32_t* qlen;        // queue, feb (a,); hier: the sum of lqlen, or null
  int32_t* wake_tmr;    // queue, feb, hier (a,)
  bool* lock;           // lock (a,)
  int32_t* next_tkt;    // ticket (a,)
  int32_t* serving;     // ticket (a,)
  bool* feb;            // feb (a,): the full/empty bit
  // hier (colibri_hier, hw_event): G groups a bank, the flat queue id
  // of (bank b, group g) is b * G + g
  int32_t* lqbuf;       // (a * G, group_cap) local queues
  int32_t* lqhead;      // (a * G,)
  int32_t* lqlen;       // (a * G,)
  int32_t* ggq;         // (a, G) global FIFO of group ids
  bool* g_inq;          // (a, G) group registered in it
  int32_t* cur_grp;     // (a,) group holding the turn, -1 idle
  int32_t* turn_srv;    // (a,) ops served this turn (colibri_hier only)
  int32_t* gqhead;      // (a,)
  int32_t* gqlen;       // (a,)
  int32_t* wake_grp;    // (a,) group whose local queue to wake
};

// a protocol family and its scalars (kernel.py's kernel_args)
struct Family {
  int proto, q_cap, q_full, lat, acq_tmr, wake_delay, msg_rule;
};

// the two-level queues' geometry (kernel_args): groups a bank, cores a
// group (the last takes the rest), slots of a local queue, and the
// local wake delay (the cross-group hand-off's is Family::wake_delay)
struct Groups {
  int count, size, cap, local_delay;
};

// what a bank's update does to its winner: the OUT_* code, the response
// timer of a RESP outcome, the side messages, and the per-core write
// (ticket_lock's held ticket: xval where xset)
struct Outcome {
  int kind;
  int32_t tmr;
  int msgs;
  bool xset;
  int32_t xval;
};

// The protocol's update of bank b for this cycle's winner `win` (acq or
// rel: its request phase; neither when the bank has no request); `tkt`
// is the winner's held ticket (ticket_lock only), `g` the two-level
// queues' geometry (colibri_hier and hw_event only).  With kWide false
// only the families up to kTicket have a branch (see engine_run_kernel).
template <bool kWide>
__device__ __forceinline__ Outcome bank_update(const BankState& bs,
                                               const Family& f,
                                               const Groups& g, int b,
                                               int32_t win, bool acq,
                                               bool rel, int32_t tkt) {
  Outcome o{kOutNone, acq ? f.acq_tmr : f.lat, 0, false, 0};
  int& kind = o.kind;
  switch (f.proto) {
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
    case kQueue:
    case kFeb: {
      // an acquire at a queue of q_full entries is rejected (lrscwait's
      // finite queue; mwait_lock's and nb_feb's never reject: q_full =
      // kBig).  nb_feb grants on its full/empty bit, not on an empty
      // queue, and the grantee enters the queue at its head all the same
      int32_t qh = bs.qhead[b], ql = bs.qlen[b];
      const bool empty = ql == 0, full = ql >= f.q_full;
      const bool fb = kWide && f.proto == kFeb;
      const bool bit = fb && bs.feb[b];
      const bool free_now = fb ? bit : empty;
      const bool grant = acq && free_now;
      const bool enq = acq && !free_now && !full;
      const bool rej = acq && full;
      const bool put = acq && !full;
      if (put) {
        const int slot = (qh + ql) % f.q_cap;
        bs.qbuf[static_cast<long long>(b) * f.q_cap + slot] = win;
      }
      kind = grant ? kOutGrant
           : enq   ? kOutSleep
           : rej   ? kOutFail
           : rel   ? kOutDone
                   : kOutNone;
      if (rel) qh = (qh + 1) % f.q_cap;
      ql = ql + (put ? 1 : 0) - (rel ? 1 : 0);
      const bool pend = rel && ql > 0;
      if (pend) bs.wake_tmr[b] = f.wake_delay;
      bs.qhead[b] = qh;
      bs.qlen[b] = ql;
      // readFE empties the bit, a writeEF that drains the queue fills it
      if (fb) bs.feb[b] = (rel && ql == 0) || (bit && !acq);
      if (f.msg_rule == kMsgsEnqPend) {
        o.msgs = 2 * ((enq ? 1 : 0) + (pend ? 1 : 0));
      } else if (f.msg_rule == kMsgsEnq) {
        o.msgs = enq ? 2 : 0;
      }
      break;
    }
    case kLock: {
      // test&set: an acquire takes a free lock or fails; a release
      // clears it (a winner is an acquire or a release, never both)
      const bool held = bs.lock[b];
      const bool got = acq && !held;
      kind = got ? kOutGrant : acq ? kOutFail : rel ? kOutDone : kOutNone;
      bs.lock[b] = (held || got) && !rel;
      if (f.msg_rule == kMsgsAcq && acq) o.msgs = 2;
      break;
    }
    case kTicket: {
      // the first attempt draws a ticket, a re-poll keeps the one it
      // holds; granted iff it is the one served; a release serves the
      // next and drops the ticket
      int32_t nt = bs.next_tkt[b];
      const bool draw = acq && tkt < 0;
      const int32_t mine = draw ? nt : tkt;
      if (draw) nt = wadd(nt, 1);
      const int32_t sv = bs.serving[b];
      kind = acq && mine == sv ? kOutGrant
           : acq               ? kOutFail
           : rel               ? kOutDone
                               : kOutNone;
      bs.next_tkt[b] = nt;
      if (rel) bs.serving[b] = wadd(sv, 1);
      o.xset = acq || rel;
      o.xval = rel ? -1 : mine;
      break;
    }
    case kHier:
    case kEvent: {
      // colibri_hier's and hw_event's fused_access, statement by
      // statement in the reference's order: later statements read what
      // earlier ones wrote.  A bank without a winner is left as it is.
      if (!kWide || (!acq && !rel)) break;
      const bool budget = f.proto == kHier;  // hw_event has no turn budget
      const bool hmsg = f.msg_rule == kMsgsHier;
      const int G = g.count;
      const long long row = static_cast<long long>(b) * G;
      const int32_t gb = min(win / g.size, G - 1);  // the winner's group
      const long long lq = row + gb;                // its local queue
      int32_t cur = bs.cur_grp[b], gqh = bs.gqhead[b], gql = bs.gqlen[b];
      int32_t tsrv = budget ? bs.turn_srv[b] : 0;
      int32_t ll = bs.lqlen[lq];
      int msgs = 0;
      // ---- acquire: an idle address is granted, else the winner sleeps
      // in its group's local queue
      const bool idle = cur < 0;
      const bool grant = acq && idle;
      if (grant) {
        cur = gb;
        tsrv = 0;
      }
      const bool enq = acq && !idle;
      if (enq) {
        const int slot = (bs.lqhead[lq] + ll) % g.cap;
        bs.lqbuf[lq * g.cap + slot] = win;
        ll += 1;
        bs.lqlen[lq] = ll;
        if (bs.qlen != nullptr) bs.qlen[b] += 1;
        if (hmsg) msgs += 1;                      // local SuccessorUpdate
      }
      // the first waiter of a group not serving registers it globally
      if (enq && cur != gb && !bs.g_inq[lq]) {
        bs.ggq[row + (gqh + gql) % G] = gb;
        gql += 1;
        bs.g_inq[lq] = true;
        msgs += hmsg ? 2 : 1;
      }
      // ---- release (the releaser's group is cur): with competitors
      // registered, colibri_hier's group yields after `size` ops
      const int32_t srv = wadd(tsrv, 1);
      const bool exhausted = budget && rel && srv >= g.size && gql > 0;
      if (rel && ll > 0 && !exhausted) {          // wake the next local
        bs.wake_grp[b] = gb;
        bs.wake_tmr[b] = g.local_delay;
        if (hmsg) msgs += 1;
        tsrv = srv;
      }
      if (rel && ll > 0 && exhausted) {           // re-register at the tail
        bs.ggq[row + (gqh + gql) % G] = gb;
        gql += 1;
        bs.g_inq[lq] = true;
        msgs += 2;
      }
      const bool end_turn = rel && (ll == 0 || exhausted);
      const bool have_next = end_turn && gql > 0;
      if (have_next) {                            // cross-group hand-off
        const int32_t nx = bs.ggq[row + gqh];
        cur = nx;
        bs.g_inq[row + nx] = false;
        gqh = (gqh + 1) % G;
        gql -= 1;
        bs.wake_grp[b] = nx;
        bs.wake_tmr[b] = f.wake_delay;
        tsrv = 0;
        msgs += 2;
      }
      if (end_turn && !have_next) cur = -1;       // the address goes idle
      bs.cur_grp[b] = cur;
      bs.gqhead[b] = gqh;
      bs.gqlen[b] = gql;
      if (budget) bs.turn_srv[b] = tsrv;
      kind = grant ? kOutGrant : enq ? kOutSleep : kOutDone;
      o.msgs = msgs;
      break;
    }
    default:
      break;
  }
  return o;
}

struct Scalars {
  int n, cyc, shift, cycles;
  Family f;
  Groups g;
};

__global__ void __launch_bounds__(kThreads)
engine_step_kernel(const int32_t* __restrict__ cand,
                   const int32_t* __restrict__ rot,
                   const int32_t* __restrict__ addr,
                   const int32_t* __restrict__ phase,
                   const int32_t* __restrict__ acq_start,
                   const int32_t* __restrict__ tkt, BankState bs,
                   int32_t* xval_out, bool* xmask_out, bool* valid_out,
                   int32_t* win_out, int32_t* kind_out, int32_t* tmr_out,
                   int32_t* stats, int32_t* hist, Scalars sc) {
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
  const Outcome oc =
      bank_update<true>(bs, sc.f, sc.g, b, win, valid && ph == kAcq,
                        valid && ph == kRel, tkt != nullptr ? tkt[wcs] : -1);
  const int kind = oc.kind, extra_msgs = oc.msgs;
  const int32_t tmr = oc.tmr;
  valid_out[b] = valid;
  win_out[b] = win;
  kind_out[b] = kind;
  tmr_out[b] = tmr;
  if (xval_out != nullptr) {
    xval_out[b] = oc.xval;
    xmask_out[b] = oc.xset;
  }

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

// backoff base by failure streak, streaks >= kBoTab - 1 share the last
// entry (backoff << 32 and beyond is 0)
constexpr int kBoTab = 34;
// steps a workload program may have (kernel.MAX_STEPS)
constexpr int kMaxSteps = 16;
// boundary levels a hierarchical topology may have (kernel.MAX_LEVELS)
constexpr int kMaxLevels = 2;

// per-run scalars, in the order of kernel.RUN_PARAMS (the wrapper packs
// them into an int32 array; zipf_c travels as its float32 bits, seed as
// its uint32 bits).  The backoff table and the program's step tables
// span several words each: a step's local work, modify duration,
// address mode, fixed address and barrier flag, and the barrier steps
// before it (kMaxSteps words each, the program's prog_len first); a
// hierarchical topology's extra latency and link budget, one word a
// level each (kMaxLevels words each).  Last, the fault plan's words
// (all 0 without one): the F_* flags, the kill cycle, the kills asked
// for and those a uniform kill makes, the stall and bank-stall windows
// [start, end) and their victims, the drop rate and the two drop
// streams' salts, the watchdog's timeout and the progress threshold;
// only the fault instance stages them (kNumBaseParams words before them:
// a larger static shared array moved the other instances' registers)
enum Param {
  P_N, P_A, P_N_ADDRS, P_CYCLES, P_PROTO, P_Q_CAP, P_Q_FULL, P_LAT,
  P_ACQ_TMR, P_WAKE_DELAY, P_MSG_RULE, P_PROG_LEN, P_N_BAR, P_ZIPF_C,
  P_ZIPF_N_THR, P_EXP_CAP, P_SEED, P_NET_BW, P_HOL_BLOCK, P_N_WORKERS,
  P_N_ATOMIC, P_STAGGER, P_TRACE, P_TELE_WINDOWS, P_TELE_CW, P_GROUPS,
  P_GROUP_SIZE, P_GROUP_CAP, P_LOCAL_DELAY, P_TOPO_LEVELS,
  P_TOPO_CORE_SIZE, P_TOPO_CORE_CLUSTERS, P_TOPO_BANK_CLUSTERS, P_BO_TAB,
  P_PRE_DUR = P_BO_TAB + kBoTab,
  P_MOD_DUR = P_PRE_DUR + kMaxSteps,
  P_ADDR_MODE = P_MOD_DUR + kMaxSteps,
  P_FIX_ADDR = P_ADDR_MODE + kMaxSteps,
  P_IS_BAR = P_FIX_ADDR + kMaxSteps,
  P_BAR_PREFIX = P_IS_BAR + kMaxSteps,
  P_LEVEL_EXTRA = P_BAR_PREFIX + kMaxSteps,
  P_LEVEL_BW = P_LEVEL_EXTRA + kMaxLevels,
  P_F_FLAGS = P_LEVEL_BW + kMaxLevels, P_KILL_CYC, P_N_KILL, P_N_KILL_EFF,
  P_STALL_CYC, P_STALL_END, P_N_STALL_EFF, P_BSTALL_CYC, P_BSTALL_END,
  P_N_BSTALL_EFF, P_DROP_BP, P_DROP_SALT, P_WDROP_SALT, P_WATCHDOG,
  P_PROG_THR
};
constexpr int kNumParams = P_PROG_THR + 1;
constexpr int kNumBaseParams = P_F_FLAGS;

// a hierarchical topology on the default tree (core/topologies/base.py,
// Topology.leaf_geometry):
// core i's leaf cluster is min(i / core_size, core_clusters - 1), bank
// b's is b % bank_clusters, and a (core, bank) path crosses level l when
// their clusters differ at l (leaf >> l); crossing it costs extra[l]
// cycles at issue and one of bw[l] link slots a cycle.  A flat run's
// words say levels == 0; unpack_params makes that one level with one
// cluster, which no path crosses.
struct Topo {
  int levels, core_size, core_clusters, bank_clusters;
  int extra[kMaxLevels], bw[kMaxLevels];
};

// core i's leaf cluster
__device__ __forceinline__ int core_cluster(const Topo& t, int i) {
  return min(i / t.core_size, t.core_clusters - 1);
}

// the levels a request from leaf cluster cc to bank b crosses, bit l for
// level l
__device__ __forceinline__ unsigned cross_bits(const Topo& t, int cc, int b) {
  const int bc = b % t.bank_clusters;
  unsigned bits = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < t.levels && (cc >> l) != (bc >> l)) bits |= 1u << l;
  }
  return bits;
}

// the extra latency of a path crossing the levels `bits`
__device__ __forceinline__ int32_t cross_extra(const Topo& t, unsigned bits) {
  int32_t e = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (bits >> l & 1u) e += t.extra[l];
  }
  return e;
}

// a run's scalars, unpacked from its words (the backoff and step tables
// stay in the words, in shared memory; pre_dur, mod_dur, addr_mode and
// fix_addr are step 0's, all a one-step program has)
struct RunParams {
  int n, a, n_addrs, cycles;
  Family f;
  int prog_len, n_bar;
  int pre_dur, mod_dur, addr_mode, fix_addr;
  float zipf_c;
  int zipf_n_thr;
  int exp_cap;
  uint32_t seed;
  int net_bw, hol_block, n_workers, n_atomic, stagger, trace, tele_windows,
      tele_cw;
  Groups g;
  Topo topo;
};

__host__ __device__ inline RunParams unpack_params(const int32_t* w) {
  RunParams rp;
  rp.n = w[P_N];
  rp.a = w[P_A];
  rp.n_addrs = w[P_N_ADDRS];
  rp.cycles = w[P_CYCLES];
  rp.f.proto = w[P_PROTO];
  rp.f.q_cap = w[P_Q_CAP];
  rp.f.q_full = w[P_Q_FULL];
  rp.f.lat = w[P_LAT];
  rp.f.acq_tmr = w[P_ACQ_TMR];
  rp.f.wake_delay = w[P_WAKE_DELAY];
  rp.f.msg_rule = w[P_MSG_RULE];
  rp.prog_len = w[P_PROG_LEN];
  rp.n_bar = w[P_N_BAR];
  rp.pre_dur = w[P_PRE_DUR];
  rp.mod_dur = w[P_MOD_DUR];
  rp.addr_mode = w[P_ADDR_MODE];
  rp.fix_addr = w[P_FIX_ADDR];
  static_assert(sizeof(float) == sizeof(int32_t), "float bits");
  memcpy(&rp.zipf_c, w + P_ZIPF_C, sizeof(float));
  rp.zipf_n_thr = w[P_ZIPF_N_THR];
  rp.exp_cap = w[P_EXP_CAP];
  rp.seed = static_cast<uint32_t>(w[P_SEED]);
  rp.net_bw = w[P_NET_BW];
  rp.hol_block = w[P_HOL_BLOCK];
  rp.n_workers = w[P_N_WORKERS];
  rp.n_atomic = w[P_N_ATOMIC];
  rp.stagger = w[P_STAGGER];
  rp.trace = w[P_TRACE];
  rp.tele_windows = w[P_TELE_WINDOWS];
  rp.tele_cw = w[P_TELE_CW];
  rp.g.count = w[P_GROUPS];
  rp.g.size = w[P_GROUP_SIZE];
  rp.g.cap = w[P_GROUP_CAP];
  rp.g.local_delay = w[P_LOCAL_DELAY];
  rp.topo.levels = w[P_TOPO_LEVELS];
  rp.topo.core_size = w[P_TOPO_CORE_SIZE];
  rp.topo.core_clusters = w[P_TOPO_CORE_CLUSTERS];
  rp.topo.bank_clusters = w[P_TOPO_BANK_CLUSTERS];
  for (int l = 0; l < kMaxLevels; ++l) {
    rp.topo.extra[l] = w[P_LEVEL_EXTRA + l];
    rp.topo.bw[l] = w[P_LEVEL_BW + l];
  }
  if (rp.topo.levels == 0) {
    // flat: one level whose one cluster holds every core and bank, so no
    // path crosses it (a flat run on a topology instance)
    rp.topo.levels = rp.topo.core_size = rp.topo.core_clusters = 1;
    rp.topo.bank_clusters = 1;
  }
  return rp;
}

// device pointers, in the order of kernel.RUN_PTRS (null where a key is
// absent: another protocol's bank arrays, telemetry or traces off, the
// Zipf thresholds of a run without a skewed stream); a launch takes an
// array of RunPtrs, one per block, as kNumPtrs words
enum Ptr {
  R_ST, R_TMR, R_ADDR, R_PHASE, R_NXT, R_OPC, R_OPS, R_ARR_CYC, R_STREAK,
  R_PARKED, R_ACQ_START, R_W_TMR, R_W_SERVED, R_ADDR_OPS, R_LAT_HIST,
  R_SCALARS, R_RESV_CORE, R_RESV_VALID, R_QBUF, R_QHEAD, R_QLEN,
  R_WAKE_TMR, R_LOCK, R_NEXT_TKT, R_SERVING, R_TKT, R_FEB, R_LQBUF,
  R_LQHEAD, R_LQLEN, R_GGQ, R_G_INQ, R_CUR_GRP, R_TURN_SRV, R_GQHEAD,
  R_GQLEN, R_WAKE_GRP, R_TELE, R_TRACE_STEP, R_TRACE_WAIT, R_TRACE_STATE,
  R_TRACE_QLEN, R_SCRATCH, R_PC, R_BAR_CNT, R_HOPS, R_ZIPF_THR, R_KMASK,
  R_DEAD_MASK, R_WD_SRV, R_WD_OWN, R_FAULT_MASKS, kNumPtrs
};

struct RunPtrs {
  int32_t *st, *tmr, *addr, *phase, *nxt, *opc, *ops, *arr, *streak;
  bool* parked;
  int32_t *acq, *wtmr, *wserved, *addr_ops, *hist, *scalars;
  int32_t* resv_core;
  bool* resv_valid;
  int32_t *qbuf, *qhead, *qlen, *wake_tmr;
  bool* lock;
  int32_t *next_tkt, *serving, *tkt;
  bool* feb;
  int32_t *lqbuf, *lqhead, *lqlen, *ggq;
  bool* g_inq;
  int32_t *cur_grp, *turn_srv, *gqhead, *gqlen, *wake_grp;
  int32_t *tele, *trace_step, *trace_wait;
  int8_t* trace_state;
  int32_t* trace_qlen;
  unsigned char* scratch;
  int32_t *pc, *bar_cnt;
  int32_t* hops;            // a hierarchical topology's hop count (0-d)
  const int32_t* zipf_thr;  // zipf_n_thr thresholds, nondecreasing
  // a fault plan's outputs: the holder kill's victims, the cores dead at
  // the horizon, each bank's last service cycle and last owner (the
  // watchdog's state, updated in place); and its victim masks, one byte
  // each: the uniform kill's n, the stall's n, the bank stall's a
  bool *kmask, *dead_mask;
  int32_t *wd_srv, *wd_own;
  const unsigned char* fault_masks;
};
static_assert(sizeof(RunPtrs) == kNumPtrs * sizeof(void*), "RunPtrs words");

// the run's scalar outputs, in the order of kernel.RUN_SCALARS
enum Scalar {
  S_RESP_PREV, S_MSGS, S_POLLS, S_SLEEP_CYC, S_LAT_MAX, S_ACTIVE_CYC,
  S_BACKOFF_CYC, S_BANK_OPS, S_NET_STALL, S_BAR_CYC, S_FAULTS_INJECTED,
  S_LAST_RET, S_HALT_CYC, S_KLEFT, S_RECOVERIES, kNumScalars
};

// a fault plan's flags (P_F_FLAGS; kernel.py's F_*): any fault
// machinery; a holder kill; a uniform kill; a stall window; a bank
// stall; message drops; the watchdog (armed, and the family holds
// banks); the uniform kill's and the stall's victims dead at the horizon
constexpr int F_ON = 1, F_HOLDER = 2, F_UNIFORM = 4, F_STALL = 8,
              F_BSTALL = 16, F_DROP = 32, F_WD = 64, F_DM_KILL = 128,
              F_DM_STALL = 256;
// a core's flag byte in the fault instance (the wake flags' bytes): the
// wake flag, killed while holding, a stall victim, a uniform-kill victim
constexpr unsigned char B_WOKEN = 1, B_KILLED = 2, B_STALL = 4,
                        B_KILL = 8;
// a cycle's fault counts, one set per cycle parity: whether a core
// retired, requests and wakeups dropped, holders killed, recoveries
enum FaultCount { F_RET, F_DROPS, F_WDROPS, F_KILLS, F_RECOV, kNumFCounts };
constexpr int32_t kDropDenom = 10000;  // faults.DROP_DENOM

// one cycle's counts, one set per cycle parity (C_ACC, C_XCL and C_HOPS:
// a hierarchical topology's accepted requests, those crossing the leaf
// level, and the hops of the accepted atomic requests)
enum Count {
  C_NWIN, C_XMSG, C_WAKE_LOAD, C_WACC, C_PARKED, C_FAIL, C_GRANT, C_DONE,
  C_ENQ, C_WAKES, C_SLEEP, C_BACKOFF, C_ACTIVE, C_QSUM, C_QMAX, C_BAR,
  C_ACC, C_XCL, C_HOPS, kNumCounts
};

constexpr int kTeleK = 15;  // obs.schema.TELE_K
constexpr int kRunThreads = 1024;
// dynamic shared memory a block may use beside the static arrays
constexpr size_t kMaxDynSmem = 227 * 1024 - 1024;

// per-bank (and per-core flag) layout, in shared memory or the scratch
struct Layout {
  size_t ints, reqw, xw, bytes, total;
};

// the keys, the per-bank words, the request words (one bit a core) and a
// hierarchical topology's crossing request words (kMaxLevels x as many),
// the per-bank bytes and the wake flags
__host__ __device__ inline Layout run_layout(int n, int a) {
  Layout L;
  const size_t nw = static_cast<size_t>((n + 31) / 32);
  L.ints = 16 * static_cast<size_t>(a);         // keys: 2 x a u64
  L.reqw = L.ints + 20 * static_cast<size_t>(a);  // 5 x a int32
  L.xw = L.reqw + 4 * nw;
  L.bytes = L.xw + 4 * kMaxLevels * nw;
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

// the address of a 24-bit hash h: uniform h % n_addrs, or the Zipf
// stream.  A skewed stream (n_thr > 0) is the count of its thresholds at
// or below h (core/workloads/base.py::zipf_thresholds, built on the host
// with the C library's powf and fmaf), a binary search of at most 14
// steps over 16 383 entries; no float pow runs here.  The skew-0 stream
// is floor(fma(u, c, 1)) - 1 with u = h / 2^24: one rounding, as the
// reference's contracted 1 + u * c.
__device__ __forceinline__ int32_t addr_of_hash(uint32_t h, int mode,
                                                int n_addrs, float zipf_c,
                                                const int32_t* thr,
                                                int n_thr) {
  if (mode == kAddrZipf) {
    if (n_thr > 0) {
      int lo = 0, hi = n_thr;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (static_cast<uint32_t>(__ldg(thr + mid)) <= h) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      return lo;
    }
    const float u = __fmul_rn(static_cast<float>(h), 5.9604644775390625e-08f);
    const float x = __fmaf_rn(u, zipf_c, 1.0f);
    const int32_t v = static_cast<int32_t>(floorf(x)) - 1;
    return min(max(v, 0), n_addrs - 1);
  }
  return static_cast<int32_t>(h % static_cast<uint32_t>(n_addrs));
}

// core.sim's step_addr: the current micro-op's target of core i, its
// step's address mode and fixed address given
__device__ __forceinline__ int32_t step_addr(const RunParams& rp,
                                             const int32_t* zipf_thr,
                                             int mode, int fix, int i,
                                             int32_t opc) {
  if (mode == kAddrFixed) return fix;
  const uint32_t x = static_cast<uint32_t>(i) * 7919u + rp.seed +
                     static_cast<uint32_t>(opc) * 104729u;
  return addr_of_hash(hash24(x), mode, rp.n_addrs, rp.zipf_c, zipf_thr,
                      rp.zipf_n_thr);
}

struct Core {
  int32_t st, tmr, addr, phase, nxt, arr, opc, streak, acq, wtmr, wserved;
  int32_t tkt;  // ticket_lock's held ticket (-1: none; unused elsewhere)
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
  const RunPtrs& o;
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
    v.tkt = o.tkt != nullptr ? o.tkt[i] : -1;
    return v;
  }
  __device__ __forceinline__ void store(int, int i, const Core& v) {
    o.st[i] = v.st; o.tmr[i] = v.tmr; o.addr[i] = v.addr;
    o.phase[i] = v.phase; o.nxt[i] = v.nxt; o.arr[i] = v.arr;
    o.opc[i] = v.opc; o.streak[i] = v.streak; o.acq[i] = v.acq;
    o.wtmr[i] = v.wtmr; o.wserved[i] = v.wserved; o.parked[i] = v.parked;
    if (o.tkt != nullptr) o.tkt[i] = v.tkt;
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

// Whether bank b is held (a reservation, lock or turn is outstanding, so
// a dead owner wedges it): the protocols' `held`.  amo holds nothing and
// runs no watchdog.
template <bool kWide>
__device__ __forceinline__ bool bank_held(const BankState& bs,
                                          const Family& f, int b) {
  switch (f.proto) {
    case kLrsc: return bs.resv_valid[b];
    case kQueue: return bs.qlen[b] > 0;
    case kFeb: return kWide && bs.qlen[b] > 0;
    case kLock: return bs.lock[b];
    case kTicket: return bs.serving[b] < bs.next_tkt[b];
    case kHier:
    case kEvent: return kWide && bs.cur_grp[b] >= 0;
    default: return false;
  }
}

// The reservation watchdog's recovery at the stuck bank b: the
// protocols' on_timeout.  `owner` is the bank's last grantee (n:
// unknown), killed(x) whether core x is permanently dead.  Returns the
// OUT_* recovery code and adds the recovery's messages to *msgs.
template <bool kWide, class Killed>
__device__ __forceinline__ int on_timeout(const BankState& bs,
                                          const Family& f, const Groups& g,
                                          int b, int n, int32_t owner,
                                          const Killed& killed, int* msgs) {
  const bool own_dead = owner < n && killed(owner);
  switch (f.proto) {
    case kQueue:
    case kFeb: {
      // the queue head is the owner: evict a dead head (the next waiter
      // is woken), else its wakeup was lost: re-send it
      const int32_t qh = bs.qhead[b];
      const int32_t head = bs.qbuf[static_cast<long long>(b) * f.q_cap + qh];
      const bool head_dead = head >= 0 && killed(min(head, n - 1));
      int32_t ql = bs.qlen[b];
      if (head_dead) {
        bs.qhead[b] = (qh + 1) % f.q_cap;
        ql -= 1;
        bs.qlen[b] = ql;
      }
      const bool wake = ql > 0;
      if (wake) {
        bs.wake_tmr[b] = f.wake_delay;
        *msgs += 2;
      }
      return head_dead ? kOutEvict : wake ? kOutRedeliver : kOutNone;
    }
    case kLrsc:
      // the stale reservation expires, whatever its owner's state
      bs.resv_valid[b] = false;
      return kOutEvict;
    case kLock:
      if (!own_dead) return kOutNone;
      bs.lock[b] = false;  // force-free; the spinners' re-polls take it
      return kOutEvict;
    case kTicket:
      if (!own_dead) return kOutNone;
      bs.serving[b] = wadd(bs.serving[b], 1);  // skip the dead ticket
      return kOutEvict;
    case kHier:
    case kEvent: {
      if (!kWide) return kOutNone;
      // the holder is not queued: replay the hand-off a dead one would
      // have made (the next local waiter, else the next registered
      // group, else idle); a live one's wake was lost: re-send it
      const int G = g.count;
      const long long row = static_cast<long long>(b) * G;
      int32_t cur = bs.cur_grp[b], wg = bs.wake_grp[b];
      bool more_local = false, have_next = false, redeliver = false;
      if (own_dead) {
        const int32_t gg = min(max(cur, 0), G - 1);
        more_local = bs.lqlen[row + gg] > 0;
        if (more_local) {
          wg = gg;
          bs.wake_tmr[b] = g.local_delay;
        } else {
          int32_t gql = bs.gqlen[b];
          have_next = gql > 0;
          if (have_next) {
            const int32_t gqh = bs.gqhead[b];
            const int32_t nx = bs.ggq[row + gqh];
            cur = nx;
            bs.g_inq[row + nx] = false;
            bs.gqhead[b] = (gqh + 1) % G;
            bs.gqlen[b] = gql - 1;
            wg = nx;
            bs.wake_tmr[b] = f.wake_delay;
          } else {
            cur = -1;
          }
        }
        if (f.proto == kHier) bs.turn_srv[b] = 0;
        bs.cur_grp[b] = cur;
        bs.wake_grp[b] = wg;
      } else {
        redeliver = bs.lqlen[row + wg] > 0;
        if (redeliver) bs.wake_tmr[b] = g.local_delay;
      }
      if (more_local || have_next || redeliver) *msgs += 2;
      return own_dead ? kOutEvict : redeliver ? kOutRedeliver : kOutNone;
    }
    default:
      return kOutNone;
  }
}

// kWide: the instance with every family's branch.  The two-level queues
// and nb_feb's bit run only in it; the instance the other families run on
// (kWide false) has their code compiled out: in one instance for all,
// it slowed every family's cycle by 5-12 % on the H100 (engine_run's
// device time in chip_smoke.py), at one register more.
//
// kProg (with kWide): the instance that runs workload programs, more than
// one step or a barrier step; the others run one-step barrier-free
// programs with the program code compiled out.  It keeps no program
// counter: every retirement adds one to opc and nothing else moves the
// program counter or the barrier count, so pc = opc mod L, ops = opc / L
// and bar_cnt = (opc / L) * n_bar + bar_prefix[opc mod L], which is
// nondecreasing in opc.  The barrier release (core.sim: after this
// cycle's arrivals, before the workers' stage) needs the least bar_cnt
// over the atomic cores, which is that function of their least opc: it is
// reduced in the core stage, ahead of barrier 1, and the release is
// applied in the census pass.  Between the two nothing reads a waiter's
// state or timer (acceptance and the bank side read REQ cores, the wake
// pass SLEEP ones), so the order is the reference's.
//
// kTopo (with kWide and kProg): the instance for launches that hold a
// run on a hierarchical topology (its flat runs and one-step programs
// take it too, a flat run as one level that no path crosses).  A request
// pays its crossed levels' extra latency at issue.  In the acceptance pass a requester
// crossing level l also needs a rank below bw[l] among that level's
// requesters in rotated order: the first pass writes each level's
// request words beside the request words (one ballot a level) and counts
// them, and only when a level has more requesters than its budget does
// the pass take the prefix counts of its words (the levels packed 16 bits
// each into one word: three warp sums).  No barrier is added.  The
// accepted requests, those crossing the leaf level and their hops are
// ballot counts of that pass; thread 0 settles net_stall, the hops and
// the telemetry's local/cross split when it folds the cycle.  The other
// instances have this code compiled out.
//
// kFault (with kWide, kProg and kTopo): the instance for launches that
// hold a run with a fault plan (the launch's other runs take it too, as
// they would the topology instance).  Dead cores (a holder kill's or a
// uniform kill's victims, a stall's inside its window) freeze in the core
// stage; a fresh request drops in the acceptance pass and a stalled
// bank's parked cores leave no key; a firing wake drops in the wake pass.
// After the census, the first `kleft` cores by core index handed
// ownership this cycle (granted at a bank, or woken) are killed: their
// candidate bits are ballot words (in the levels' request words, free by
// then), each core's rank a prefix count of them, with a barrier before
// the ranks and one after the kill flags (only while kills are left).
// Then each bank's watchdog re-arms on a sign of life and, stuck, runs its
// family's on_timeout, and the queue depths are counted after it.  The
// retire flag, the drops, kills and recoveries are counts per cycle
// parity that thread 0 folds with the others (faults_injected,
// recoveries, the progress detector's last_ret and halt_cyc).  The other
// instances have this code compiled out.
template <class Cores, int kMaxThreads, bool kWide, bool kProg, bool kTopo,
          bool kFault>
__global__ void __launch_bounds__(kMaxThreads)
engine_run_kernel(const int32_t* __restrict__ params,
                  const RunPtrs* __restrict__ ptrs, int kc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int32_t s_hist[kLatBins];
  __shared__ int32_t s_cnt[2][kNumCounts];
  __shared__ int32_t s_minopc[2];  // least opc of the atomic cores
  __shared__ int32_t s_xreq[2][kMaxLevels];  // each level's requesters
  __shared__ int32_t s_fcnt[2][kNumFCounts];  // the fault counts
  __shared__ int32_t s_lat_max;
  __shared__ int32_t s_par[kFault ? kNumParams : kNumBaseParams];
  __shared__ RunParams s_rp;
  __shared__ RunPtrs s_o;

  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  // this block's run, staged once in shared memory: its parameter words
  // (the backoff table is indexed at run time), its scalars and its
  // pointers.  A block of at most 256 threads keeps its scalars in
  // registers; a larger one (64 registers a thread) reads them from
  // shared memory, as it does the pointers, rather than spill.
  for (int j = tid; j < (kFault ? kNumParams : kNumBaseParams); j += T) {
    s_par[j] = params[static_cast<size_t>(blockIdx.x) * kNumParams + j];
  }
  if (tid == 0) s_o = ptrs[blockIdx.x];
  __syncthreads();
  if (tid == 0) s_rp = unpack_params(s_par);
  __syncthreads();
  const RunParams rp_regs = s_rp;
  const RunParams& rp = kMaxThreads <= 256 ? rp_regs : s_rp;
  const int32_t* bo_tab = s_par + P_BO_TAB;
  const RunPtrs& o = s_o;
  const int n = rp.n, a = rp.a, cycles = rp.cycles;
  const int proto = rp.f.proto;
  const bool lrsc = proto == kLrsc, lock = proto == kLock;
  const bool ticket = proto == kTicket, has_feb = kWide && proto == kFeb;
  // one FIFO a bank (lrscwait, colibri, mwait_lock, nb_feb) or the
  // two-level queues (colibri_hier, hw_event): both have a wake pass
  const bool fifo = proto == kQueue || has_feb;
  const bool hier = kWide && (proto == kHier || proto == kEvent);
  const bool queue = fifo || hier;
  const bool workers = rp.n_workers > 0, tele = rp.tele_windows > 0;
  const bool trace = rp.trace != 0;
  // the topology's words are read from shared memory, not held in
  // registers through the cycle loop; a topology instance runs every run
  // through the topology stages (a flat run as one level nothing crosses)
  const Topo& tp = s_rp.topo;
  constexpr bool topo = kTopo;
  // the program: its steps and whether it has a barrier step
  const int n_steps = kProg ? rp.prog_len : 1;
  const bool bars = kProg && rp.n_bar > 0;
  // barrier arrivals after `opc` retirements
  auto bar_count = [&](int32_t opc) {
    return (opc / n_steps) * rp.n_bar +
           s_par[P_BAR_PREFIX + opc % n_steps];
  };
  // the fault plan (its words stay in shared memory)
  int fflags = 0;
  if constexpr (kFault) fflags = s_par[P_F_FLAGS];
  const bool fon = (fflags & F_ON) != 0;
  const bool holder = (fflags & F_HOLDER) != 0;
  const bool uniform = (fflags & F_UNIFORM) != 0;
  const bool stall = (fflags & F_STALL) != 0;
  const bool bstall = (fflags & F_BSTALL) != 0;
  const bool drop = (fflags & F_DROP) != 0;
  const bool wd = (fflags & F_WD) != 0;
  int32_t kleft = holder ? s_par[P_N_KILL] : 0;  // kills left (uniform)

  const Layout L = run_layout(n, a);
  unsigned char* base = L.total <= kMaxDynSmem ? smem_raw : o.scratch;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);
  int32_t* ints = reinterpret_cast<int32_t*>(base + L.ints);
  int32_t* addr_ops = ints;
  uint32_t* reqw = reinterpret_cast<uint32_t*>(base + L.reqw);
  uint32_t* xw = reinterpret_cast<uint32_t*>(base + L.xw);  // level l's
  bool* resv_valid = reinterpret_cast<bool*>(base + L.bytes);
  // the wake flags; in the fault instance each core's B_* flag byte
  unsigned char* woken = base + L.bytes + a;
  // core i permanently dead at cycle c (a holder kill's victim, or a
  // uniform kill's from kill_cyc on), or dead (also inside a stall)
  auto killed_at = [&](int i, int c) {
    const unsigned char fl = woken[i];
    return holder ? (fl & B_KILLED) != 0
                  : uniform && c >= s_par[P_KILL_CYC] && (fl & B_KILL);
  };
  auto dead_at = [&](int i, int c) {
    return killed_at(i, c) ||
           (stall && (woken[i] & B_STALL) && c >= s_par[P_STALL_CYC] &&
            c < s_par[P_STALL_END]);
  };
  // a block runs one family, so the families share the per-bank slots:
  // the lock bits and nb_feb's full/empty bits are resv_valid's bytes,
  // next_tkt and serving are resv_core's and qhead's words, and the
  // two-level queues keep cur_grp, gqhead and wake_tmr in resv_core's,
  // qhead's and wake_tmr's words and the sum of a bank's local queue
  // lengths (its queue depth) in qlen's.  Their other per-bank words
  // (turn_srv, gqlen, wake_grp) and per-(bank, group) arrays stay in
  // device memory, updated in place, as qbuf does: the layout is the
  // same for every family.
  BankState bs{ints + a,     resv_valid,   o.qbuf,       ints + 2 * a,
               ints + 3 * a, ints + 4 * a, resv_valid,   ints + a,
               ints + 2 * a, resv_valid,   o.lqbuf,      o.lqhead,
               o.lqlen,      o.ggq,        o.g_inq,      ints + a,
               o.turn_srv,   ints + 2 * a, o.gqlen,      o.wake_grp};

  for (int b = tid; b < a; b += T) {
    keys[b] = kNoKey;
    keys[a + b] = kNoKey;
    addr_ops[b] = 0;
    if (lrsc) {
      bs.resv_core[b] = o.resv_core[b];
      bs.resv_valid[b] = o.resv_valid[b];
    }
    if (fifo) {
      bs.qhead[b] = o.qhead[b];
      bs.qlen[b] = o.qlen[b];
      bs.wake_tmr[b] = o.wake_tmr[b];
    }
    if (has_feb) bs.feb[b] = o.feb[b];
    if (hier) {
      bs.cur_grp[b] = o.cur_grp[b];
      bs.gqhead[b] = o.gqhead[b];
      bs.wake_tmr[b] = o.wake_tmr[b];
      int32_t depth = 0;
      for (int j = 0; j < s_rp.g.count; ++j) {
        depth += o.lqlen[static_cast<size_t>(b) * s_rp.g.count + j];
      }
      bs.qlen[b] = depth;
    }
    if (lock) bs.lock[b] = o.lock[b];
    if (ticket) {
      bs.next_tkt[b] = o.next_tkt[b];
      bs.serving[b] = o.serving[b];
    }
  }
  for (int i = tid; i < n; i += T) {
    woken[i] = 0;
    if constexpr (kFault) {
      if (fon) {
        woken[i] = (o.fault_masks[i] ? B_KILL : 0) |
                   (o.fault_masks[n + i] ? B_STALL : 0);
      }
    }
  }
  for (int j = tid; j < kLatBins; j += T) s_hist[j] = 0;
  for (int j = tid; j < 2 * kNumCounts; j += T) (&s_cnt[0][0])[j] = 0;
  if constexpr (kFault) {
    for (int j = tid; j < 2 * kNumFCounts; j += T) (&s_fcnt[0][0])[j] = 0;
  }
  if (tid == 0) {
    s_lat_max = 0;
    s_minopc[0] = s_minopc[1] = kBig;
    for (int l = 0; l < kMaxLevels; ++l) s_xreq[0][l] = s_xreq[1][l] = 0;
  }

  Cores S(o, kc);
  // the leaf clusters of this thread's first two cores, kept in registers
  // (cores past them, in device memory, are divided out where needed)
  const int ccl0 = topo ? core_cluster(tp, tid) : 0;
  const int ccl1 = topo ? core_cluster(tp, tid + T) : 0;
  auto ccl = [&](int k, int i) {
    return k == 0 ? ccl0 : k == 1 ? ccl1 : core_cluster(tp, i);
  };
#pragma unroll
  for (int k = 0; k < S.count(); ++k) {
    const int i = tid + k * T;
    if (i < n) {
      Core c;
      c.st = kWork;
      c.tmr = (i * 3) % rp.stagger;
      c.addr = c.phase = c.nxt = c.opc = c.streak = c.acq = 0;
      c.wtmr = c.wserved = 0;
      c.arr = c.tkt = -1;
      c.parked = false;
      S.store(k, i, c);
    }
  }

  // thread 0's run totals (int32, wrapping) and telemetry row
  int32_t msgs = 0, polls = 0, sleep_cyc = 0, backoff_cyc = 0,
          active_cyc = 0, bank_ops = 0, net_stall = 0, bar_cyc = 0,
          hops = 0;
  int32_t stall_now = 0, acc_now = 0, stall_prev = 0, acc_prev = 0;
  // and the fault plan's (faults_injected, recoveries, the progress
  // detector's last retirement and halt cycle)
  int32_t finj = 0, recov = 0, last_ret = 0, halt = -1;
  int32_t row[kTeleK];
#pragma unroll
  for (int j = 0; j < kTeleK; ++j) row[j] = 0;

  // fold cycle c's counts into the totals (thread 0); on a hierarchical
  // topology stall_c + acc_c is the cycle's requesters, of which the
  // acceptance pass counted those accepted
  auto fold = [&](const int32_t* cnt, int c, int32_t stall_c, int32_t acc_c) {
    int32_t xcl = 0;
    if (topo) {
      const int32_t req = wadd(stall_c, acc_c);
      acc_c = cnt[C_ACC];
      stall_c = wsub(req, acc_c);
      net_stall = wadd(net_stall, stall_c);
      xcl = cnt[C_XCL];
      // each accepted request's hop path twice, a worker load's hop twice
      const int32_t h = wadd(cnt[C_HOPS], cnt[C_WACC]);
      hops = wadd(hops, wadd(h, h));
    }
    const int32_t nwin = cnt[C_NWIN];
    int32_t msgs_now = wadd(wadd(nwin, nwin), cnt[C_XMSG]);
    if constexpr (kFault) {
      if (fon) {
        const int32_t* fc = s_fcnt[c & 1];
        // a dropped request crossed the network once (no response slot)
        msgs_now = wadd(msgs_now, fc[F_DROPS]);
        int32_t sched = 0;  // the scheduled faults taking effect at c
        if (uniform && c == s_par[P_KILL_CYC]) sched += s_par[P_N_KILL_EFF];
        if (stall && c == s_par[P_STALL_CYC]) sched += s_par[P_N_STALL_EFF];
        if (bstall && c == s_par[P_BSTALL_CYC]) {
          sched += s_par[P_N_BSTALL_EFF];
        }
        finj = wadd(finj, wadd(wadd(sched, fc[F_DROPS]),
                               wadd(fc[F_WDROPS], fc[F_KILLS])));
        recov = wadd(recov, fc[F_RECOV]);
        if (fc[F_RET]) last_ret = c;
        if (halt < 0 && c - last_ret >= s_par[P_PROG_THR]) halt = c;
      }
    }
    msgs = wadd(msgs, msgs_now);
    polls = wadd(polls, cnt[C_FAIL]);
    bank_ops = wadd(bank_ops, nwin);
    const int32_t sleep_now = cnt[C_SLEEP], backoff_now = cnt[C_BACKOFF];
    const int32_t bar_now = kProg ? cnt[C_BAR] : 0;
    // workers are never asleep nor at a barrier
    const int32_t active_now =
        workers ? cnt[C_ACTIVE] : wsub(wsub(rp.n_atomic, sleep_now), bar_now);
    sleep_cyc = wadd(sleep_cyc, sleep_now);
    backoff_cyc = wadd(backoff_cyc, backoff_now);
    active_cyc = wadd(active_cyc, active_now);
    if (kProg) bar_cyc = wadd(bar_cyc, bar_now);
    if (tele) {
      const int32_t add[kTeleK - 1] = {
          active_now, sleep_now, backoff_now, bar_now, cnt[C_GRANT],
          cnt[C_DONE],
          cnt[C_FAIL], cnt[C_ENQ], cnt[C_WAKES], msgs_now, stall_c,
          wsub(acc_c, xcl), xcl, cnt[C_QSUM]};
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
    // a holder kill may take victims this cycle (uniform)
    const bool kill_now =
        kFault && holder && kleft > 0 && cyc >= s_par[P_KILL_CYC];

    // ---- timers, issue, retire, backoff, workers; the request words
    int32_t l_minopc = kBig;
    bool l_ret = false;  // a core of this thread retired (fault instance)
#pragma unroll
    for (int k = 0; k < S.count(); ++k) {
      const int i = tid + k * T;
      bool req = false;
      unsigned xb = 0;  // the levels a fresh request crosses
      if (i < n) {
        Core c = S.load(k, i);
        const bool worker = workers && i < rp.n_workers;
        // a dead core's timer runs, but it neither fires nor sends
        bool dead = false;
        if constexpr (kFault) dead = fon && dead_at(i, cyc);
        c.tmr = max(c.tmr - 1, 0);
        const bool t0 = c.tmr == 0 && !dead;
        const bool start = t0 && c.st == kWork && !worker;
        const bool rb = t0 && c.st == kBackoff;
        const bool md = t0 && c.st == kMod;
        if (start) {
          if (kProg) {
            const int pc = c.opc % n_steps;
            c.addr = step_addr(rp, o.zipf_thr, s_par[P_ADDR_MODE + pc],
                               s_par[P_FIX_ADDR + pc], i, c.opc);
          } else {
            c.addr = step_addr(rp, o.zipf_thr, rp.addr_mode, rp.fix_addr,
                               i, c.opc);
          }
          c.acq = cyc;
        }
        if (start || rb) c.phase = kAcq;
        if (md) c.phase = kRel;
        if (start || rb || md) {
          c.st = kReq;
          c.tmr = rp.f.lat;
          // the crossed levels' extra latency, once per issue
          if (topo) {
            c.tmr += cross_extra(tp, cross_bits(tp, ccl(k, i), c.addr));
          }
        }
        const bool ra = t0 && c.st == kResp;
        const bool done = ra && c.nxt == kNxtWorkDone;
        int step = 0;  // the retiring micro-op's program counter
        if (done) {
          if (kProg) {
            // a barrier step parks at the barrier (its timer is 0), any
            // other goes to the next step's local work
            step = c.opc % n_steps;
            if (s_par[P_IS_BAR + step]) {
              c.st = kBarWait;
            } else {
              c.st = kWork;
              const int next = step + 1 == n_steps ? 0 : step + 1;
              c.tmr = s_par[P_PRE_DUR + next];
            }
          } else {
            c.st = kWork;
            c.tmr = rp.pre_dur;
          }
          c.opc = wadd(c.opc, 1);
          c.streak = 0;
          atomicAdd(&addr_ops[c.addr], 1);
        }
        if (ra && c.nxt == kNxtMod) {
          c.st = kMod;
          c.tmr = kProg ? s_par[P_MOD_DUR + c.opc % n_steps] : rp.mod_dur;
        }
        if (ra && c.nxt == kNxtBackoff) {
          c.st = kBackoff;
          c.streak = min(c.streak + 1, rp.exp_cap);
          c.tmr = wadd(bo_tab[min(c.streak, kBoTab - 1)],
                       jitter(static_cast<uint32_t>(cyc + i)));
        }
        if (trace) {
          const size_t at = static_cast<size_t>(cyc) * n + i;
          o.trace_wait[at] = done ? cyc - c.acq : -1;
          o.trace_step[at] = done ? step : -1;
        }
        if (bars && !worker) l_minopc = min(l_minopc, c.opc);
        if constexpr (kFault) l_ret = l_ret || done;
        if (workers) c.wtmr = max(c.wtmr - 1, 0);
        const bool fresh =
            c.st == kReq && c.tmr == 0 && !c.parked && !worker && !dead;
        req = fresh || (worker && c.wtmr == 0 && !dead);
        if (topo && fresh) xb = cross_bits(tp, ccl(k, i), c.addr);
        S.store(k, i, c);
      }
      const unsigned word = __ballot_sync(kFull, req);
      const int w = k * (T >> 5) + wid;
      if (lane == 0 && w < nw) reqw[w] = word;
      if (topo) {
#pragma unroll
        for (int l = 0; l < kMaxLevels; ++l) {
          const unsigned xword = __ballot_sync(kFull, xb >> l & 1u);
          if (lane == 0 && w < nw) xw[l * nw + w] = xword;
          if (lane == 0 && xword) atomicAdd(&s_xreq[par][l], __popc(xword));
        }
      }
    }
    if (bars) {
      const unsigned m =
          __reduce_min_sync(kFull, static_cast<unsigned>(l_minopc));
      if (lane == 0) atomicMin(&s_minopc[par], static_cast<int32_t>(m));
    }
    if constexpr (kFault) {
      const unsigned rets = __ballot_sync(kFull, l_ret);
      if (lane == 0 && rets) s_fcnt[par][F_RET] = 1;
    }
    __syncthreads();  // 1: request words, the least opc
    // last read in the previous cycle's census pass, next written in the
    // next cycle's core stage (after barrier 2)
    if (bars && tid == 0) s_minopc[par ^ 1] = kBig;
    // the same for the levels' requester counts (read in the acceptance
    // pass before barrier 2, written in the first pass)
    if (topo && tid == 0) {
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) s_xreq[par ^ 1][l] = 0;
    }

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
      if (!topo) net_stall = wadd(net_stall, stall_now);
    }
    // the levels' request counts in word w under mask m, 16 bits a level
    auto xpop = [&](int w, unsigned m) {
      unsigned v = 0;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        v |= static_cast<unsigned>(__popc(xw[l * nw + w] & m)) << (16 * l);
      }
      return v;
    };
    // a level whose requesters exceed its budget ranks them: all of them,
    // and those of cores [0, j0), 16 bits a level (xrank is uniform)
    bool xrank = false;
    if (topo) {
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        xrank = xrank || s_xreq[par][l] > tp.bw[l];
      }
    }
    unsigned xtot = 0, xpj0 = 0;
    if (xrank) {
      for (int w = lane; w < nw; w += 32) {
        const unsigned v = xpop(w, kFull);
        xtot += v;
        if (w < (j0 >> 5)) xpj0 += v;
      }
      xtot = __reduce_add_sync(kFull, xtot);
      xpj0 = __reduce_add_sync(kFull, xpj0) +
             xpop(j0 >> 5, (1u << (j0 & 31)) - 1u);
    }

    // a hierarchical topology's counts: the accepted requests, the atomic
    // ones, and those crossing each level (warp-uniform ballot counts)
    int32_t l_wacc = 0, l_acc = 0, l_fresh = 0, l_x[kMaxLevels] = {};
    int32_t l_drop = 0;  // requests dropped in flight (fault instance)
    // a bank stall's window: its banks take no request
    const bool bs_now = bstall && cyc >= s_par[P_BSTALL_CYC] &&
                        cyc < s_par[P_BSTALL_END];
#pragma unroll
    for (int k = 0; k < S.count(); ++k) {
      const int i = tid + k * T;
      const int wk = k * (T >> 5) + wid;  // this warp's word (uniform)
      int32_t pre = 0;
      for (int w = lane; w < wk; w += 32) pre += __popc(reqw[w]);
      pre = static_cast<int32_t>(__reduce_add_sync(kFull, pre));
      unsigned xpre = 0;
      if (xrank) {
        for (int w = lane; w < wk; w += 32) xpre += xpop(w, kFull);
        xpre = __reduce_add_sync(kFull, xpre);
      }
      bool acc = false, fresh_acc = false;
      unsigned xb = 0;
      if (i < n) {
        Core c = S.load(k, i);
        const bool worker = workers && i < rp.n_workers;
        bool dead = false;
        if constexpr (kFault) dead = fon && dead_at(i, cyc);
        const bool fresh =
            c.st == kReq && c.tmr == 0 && !c.parked && !worker && !dead;
        const bool w_arr = worker && c.wtmr == 0 && !dead;
        if (fresh || w_arr) {
          const unsigned below = (2u << (i & 31)) - 1u;  // cores <= i
          const int32_t pi1 = pre + __popc(reqw[wk] & below);  // P(i + 1)
          const int32_t r1 = i >= j0 ? pi1 - pj0 : tot - pj0 + pi1;
          acc = r1 - 1 < budget;
          if (topo && fresh) xb = cross_bits(tp, ccl(k, i), c.addr);
          if (xrank && xb) {
            // and a slot of every level the request crosses
            const unsigned xp1 = xpre + xpop(wk, below);
#pragma unroll
            for (int l = 0; l < kMaxLevels; ++l) {
              if (xb >> l & 1u) {
                const int32_t q1 = xp1 >> (16 * l) & 0xffffu;
                const int32_t q0 = xpj0 >> (16 * l) & 0xffffu;
                const int32_t qt = xtot >> (16 * l) & 0xffffu;
                const int32_t rl = i >= j0 ? q1 - q0 : qt - q0 + q1;
                if (rl - 1 >= tp.bw[l]) acc = false;
              }
            }
          }
          if constexpr (kFault) {
            if (drop && fresh && acc) {
            // the Bernoulli drop of an accepted request: it dies in
            // flight and the core retransmits next cycle
              const uint32_t u = hash24(
                  static_cast<uint32_t>(i) * 9781u +
                  static_cast<uint32_t>(cyc) * 6271u +
                  static_cast<uint32_t>(s_par[P_DROP_SALT]));
              if (static_cast<int32_t>(u % kDropDenom) < s_par[P_DROP_BP]) {
                acc = false;
                ++l_drop;
              }
            }
          }
        }
        fresh_acc = fresh && acc;
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
        bool bank_stalled = false;
        if constexpr (kFault) {
          bank_stalled = bs_now && o.fault_masks[2 * n + c.addr];
        }
        if (c.parked && c.st == kReq && !bank_stalled) {
          const unsigned long long key = packed_key(c.arr, i, shift, n);
          atomicMin(&key_now[c.addr], key);
        }
        S.store(k, i, c);
      }
      if (topo) {
        l_acc += __popc(__ballot_sync(kFull, acc));
        l_fresh += __popc(__ballot_sync(kFull, fresh_acc));
#pragma unroll
        for (int l = 0; l < kMaxLevels; ++l) {
          l_x[l] += __popc(__ballot_sync(kFull, fresh_acc && (xb >> l & 1u)));
        }
      }
    }
    if (topo) {
      // a request's hops are 1 + 2 a crossed level
      int32_t l_hops = l_fresh;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) l_hops += 2 * l_x[l];
      warp_count(&cur[C_ACC], l_acc);
      warp_count(&cur[C_XCL], l_x[0]);
      warp_count(&cur[C_HOPS], l_hops);
    }
    if constexpr (kFault) {
      if (drop) warp_add(&s_fcnt[par][F_DROPS], l_drop);
    }
    __syncthreads();  // 2: the key minimum of every bank

    // thread 0 folds the previous cycle's counts (read by everyone
    // before barrier 2) and clears them for the next cycle
    if (tid == 0) {
      if (cyc > 0) fold(prev, cyc - 1, stall_prev, acc_prev);
#pragma unroll
      for (int j = 0; j < kNumCounts; ++j) s_cnt[par ^ 1][j] = 0;
      if constexpr (kFault) {
#pragma unroll
        for (int j = 0; j < kNumFCounts; ++j) s_fcnt[par ^ 1][j] = 0;
      }
    }
    unsigned gbits = 0;  // the cores of this thread granted at a bank
    // ---- winners: the protocol's bank update and the outcome apply
#pragma unroll
    for (int k = 0; k < S.count(); ++k) {
      const int i = tid + k * T;
      if (i < n) {
        Core c = S.load(k, i);
        if (c.parked && c.st == kReq) {
          const unsigned long long key = packed_key(c.arr, i, shift, n);
          if (key_now[c.addr] == key) {
            const Outcome oc = bank_update<kWide>(
                bs, rp.f, s_rp.g, c.addr, i, c.phase == kAcq,
                c.phase == kRel, c.tkt);
            const int kind = oc.kind, xm = oc.msgs;
            const int32_t done_cyc = cyc + max(oc.tmr, 1);
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
            if (oc.xset) c.tkt = oc.xval;
            if constexpr (kFault) {
              if (kind == kOutGrant) gbits |= 1u << k;
              // the watchdog learns the owner from a grant and re-arms
              // on a retire
              if (wd && kind == kOutGrant) o.wd_own[c.addr] = i;
              if (wd && kind == kOutDone) o.wd_srv[c.addr] = cyc;
            }
            if (kind == kOutGrant || kind == kOutDone || kind == kOutFail) {
              c.st = kResp;
              c.tmr = oc.tmr;
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
    // (the fault instance counts the queue depths after the watchdog)
    for (int b = tid; (queue || (trace && !kFault)) && b < a; b += T) {
      int32_t ql = 0;
      if (queue) {
        int32_t wt = bs.wake_tmr[b];
        if (kFault && drop && wt == 1) {
          // a lost wakeup: the firing wake message drops, the sleeping
          // head never hears it
          const uint32_t u = hash24(static_cast<uint32_t>(b) * 3643u +
                                    static_cast<uint32_t>(cyc) * 9176u +
                                    static_cast<uint32_t>(
                                        s_par[P_WDROP_SALT]));
          if (static_cast<int32_t>(u % kDropDenom) < s_par[P_DROP_BP]) {
            wt = 0;
            atomicAdd(&s_fcnt[par][F_WDROPS], 1);
          }
        }
        const int32_t wt2 = max(wt - 1, 0);
        bs.wake_tmr[b] = wt2;
        if (hier) {
          // wake the head of the chosen group's local queue and pop it:
          // it is the address's holder now
          if (wt == 1) {
            const Groups& g = s_rp.g;
            const size_t wq =
                static_cast<size_t>(b) * g.count + o.wake_grp[b];
            const int32_t wl = o.lqlen[wq];
            if (wl > 0) {
              const int32_t lh = o.lqhead[wq];
              const int32_t head = o.lqbuf[wq * g.cap + lh];
              if (head >= 0 && head < n) {
                woken[head] |= B_WOKEN;
              }
              o.lqhead[wq] = (lh + 1) % g.cap;
              o.lqlen[wq] = wl - 1;
              bs.qlen[b] -= 1;
            }
          }
          ql = bs.qlen[b];
        } else {
          ql = bs.qlen[b];
          if (wt == 1 && ql > 0) {
            const int32_t head =
                o.qbuf[static_cast<size_t>(b) * rp.f.q_cap + bs.qhead[b]];
            if (head >= 0 && head < n) {
              woken[head] |= B_WOKEN;
            }
          }
        }
        if (wt2 == 1) atomicAdd(&cur[C_WAKE_LOAD], 1);
      }
      if constexpr (!kFault) {
        l_qsum = wadd(l_qsum, ql);
        l_qmax = max(l_qmax, ql);
        if (trace) o.trace_qlen[static_cast<size_t>(cyc) * a + b] = ql;
      }
    }
    if (queue) __syncthreads();  // 4: the wake flags

    // ---- wakes, census, trace state
    int32_t l_wakes = 0, l_sleep = 0, l_backoff = 0, l_active = 0,
            l_parked = 0, l_bar = 0, l_rel = 0;
#pragma unroll
    for (int k = 0; k < S.count(); ++k) {
      const int i = tid + k * T;
      bool sl = false, bo = false, ac = false, pk = false, bw = false;
      bool cand = false;  // a holder kill's candidate (fault instance)
      if (i < n) {
        Core c = S.load(k, i);
        if (queue && (woken[i] & B_WOKEN)) {
          woken[i] &= static_cast<unsigned char>(~B_WOKEN);
          // a woken sleeper is handed ownership (a woken core that was
          // not asleep is not)
          const bool slept = c.st == kSleep;
          l_wakes += slept;
          if constexpr (kFault) {
            if (wd && slept) {
              o.wd_own[c.addr] = i;
              o.wd_srv[c.addr] = cyc;
            }
            cand = slept;
          }
          c.st = kMod;
          c.tmr = kProg ? s_par[P_MOD_DUR + c.opc % n_steps] : rp.mod_dur;
          S.store(k, i, c);
        }
        if constexpr (kFault) {
          cand = kill_now && (cand || (gbits >> k & 1u)) &&
                 !(woken[i] & B_KILLED);
        }
        if (bars && c.st == kBarWait) {
          // the barrier release: every waiter whose arrivals are at most
          // the least over the atomic cores, one wake message each
          const int32_t mo = s_minopc[par];
          if (c.opc <= mo || bar_count(c.opc) <= bar_count(mo)) {
            c.st = kWork;
            c.tmr = rp.f.lat + s_par[P_PRE_DUR + c.opc % n_steps];
            ++l_rel;
            S.store(k, i, c);
          }
        }
        sl = c.st == kSleep;
        bo = c.st == kBackoff;
        bw = bars && c.st == kBarWait;
        ac = c.st != kSleep && !bw && !(workers && i < rp.n_workers);
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
      if (bars) l_bar += __popc(__ballot_sync(kFull, bw));
      if (kFault && kill_now) {
        const unsigned word = __ballot_sync(kFull, cand);
        const int w = k * (T >> 5) + wid;
        if (lane == 0 && w < nw) xw[w] = word;
      }
    }
    if (bars) {
      warp_count(&cur[C_BAR], l_bar);
      warp_add(&cur[C_XMSG], l_rel);  // this cycle's msgs, next's budget
    }
    warp_count(&cur[C_SLEEP], l_sleep);
    warp_count(&cur[C_BACKOFF], l_backoff);
    if (workers) {
      warp_add(&cur[C_WACC], l_wacc);
      warp_count(&cur[C_ACTIVE], l_active);
    }
    if (rp.hol_block) warp_count(&cur[C_PARKED], l_parked);
    if constexpr (kFault) {
      // 5: the wake and retire stamps, the candidates (a run without a
      // plan has nothing to wait for: each bank's thread counts its own)
      if (fon) __syncthreads();
      if (kill_now) {
        // the holder kill: the first kleft candidates by core index die
        // (each core's rank: the candidates in the words before its own
        // and below it in its own)
        int32_t tot = 0;
        for (int w = lane; w < nw; w += 32) tot += __popc(xw[w]);
        tot = static_cast<int32_t>(
            __reduce_add_sync(kFull, static_cast<unsigned>(tot)));
#pragma unroll
        for (int k = 0; k < S.count(); ++k) {
          const int i = tid + k * T;
          const int wk = k * (T >> 5) + wid;  // this warp's word (uniform)
          int32_t pre = 0;
          for (int w = lane; w < min(wk, nw); w += 32) pre += __popc(xw[w]);
          pre = static_cast<int32_t>(
              __reduce_add_sync(kFull, static_cast<unsigned>(pre)));
          if (i < n && wk < nw) {
            const unsigned word = xw[wk];
            if ((word >> lane & 1u) &&
                pre + __popc(word & ((1u << lane) - 1u)) < kleft) {
              woken[i] |= B_KILLED;
            }
          }
        }
        const int32_t nk = min(tot, kleft);
        if (tid == 0) s_fcnt[par][F_KILLS] += nk;
        kleft -= nk;
        __syncthreads();  // 6: the kill flags
      }
      // ---- banks: the reservation watchdog, then the queue depths
      auto killed_now = [&](int x) { return killed_at(x, cyc); };
      for (int b = tid; b < a; b += T) {
        if (wd) {
          // re-armed by every sign of life (not held, a retire, a wake
          // hand-off: those stamped this cycle) and by a timeout
          const bool held = bank_held<kWide>(bs, rp.f, b);
          int32_t srv = held ? o.wd_srv[b] : cyc;
          if (held && wsub(cyc, srv) >= s_par[P_WATCHDOG]) {
            int xm = 0;
            const int rk = on_timeout<kWide>(bs, rp.f, s_rp.g, b, n,
                                             o.wd_own[b], killed_now, &xm);
            if (xm) atomicAdd(&cur[C_XMSG], xm);
            if (rk != kOutNone) atomicAdd(&s_fcnt[par][F_RECOV], 1);
            // an eviction vacates the bank: forget the owner
            if (rk == kOutEvict) o.wd_own[b] = n;
            srv = cyc;
          }
          o.wd_srv[b] = srv;
          if (has_feb) bs.feb[b] = bs.qlen[b] == 0;
        }
        if (queue || trace) {
          const int32_t ql = queue ? bs.qlen[b] : 0;
          l_qsum = wadd(l_qsum, ql);
          l_qmax = max(l_qmax, ql);
          if (trace) o.trace_qlen[static_cast<size_t>(cyc) * a + b] = ql;
        }
      }
    }
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
    o.scalars[S_BAR_CYC] = bar_cyc;
    if (o.hops != nullptr) *o.hops = hops;
    if (kFault && fon) {
      o.scalars[S_FAULTS_INJECTED] = finj;
      o.scalars[S_LAST_RET] = last_ret;
      o.scalars[S_HALT_CYC] = halt;
      o.scalars[S_KLEFT] = kleft;
      o.scalars[S_RECOVERIES] = recov;
    }
  }
  for (int j = tid; j < kLatBins; j += T) o.hist[j] = s_hist[j];
  for (int b = tid; b < a; b += T) {
    o.addr_ops[b] = addr_ops[b];
    if (lrsc) {
      o.resv_core[b] = bs.resv_core[b];
      o.resv_valid[b] = bs.resv_valid[b];
    }
    if (fifo) {
      o.qhead[b] = bs.qhead[b];
      o.qlen[b] = bs.qlen[b];
      o.wake_tmr[b] = bs.wake_tmr[b];
    }
    if (has_feb) o.feb[b] = bs.feb[b];
    if (hier) {
      o.cur_grp[b] = bs.cur_grp[b];
      o.gqhead[b] = bs.gqhead[b];
      o.wake_tmr[b] = bs.wake_tmr[b];
    }
    if (lock) o.lock[b] = bs.lock[b];
    if (ticket) {
      o.next_tkt[b] = bs.next_tkt[b];
      o.serving[b] = bs.serving[b];
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
        if (ticket) o.tkt[i] = c.tkt;
      }
      o.ops[i] = kProg ? c.opc / n_steps : c.opc;
      o.pc[i] = kProg ? c.opc % n_steps : 0;
      o.bar_cnt[i] = bars ? bar_count(c.opc) : 0;
      if (kFault && fon) {
        const unsigned char fl = woken[i];
        if (holder) o.kmask[i] = (fl & B_KILLED) != 0;
        o.dead_mask[i] = (fl & B_KILLED) ||
                         ((fflags & F_DM_KILL) && (fl & B_KILL)) ||
                         ((fflags & F_DM_STALL) && (fl & B_STALL));
      }
    }
  }
}

// step_addr / jitter / _hash on given inputs, for the exactness check
__global__ void engine_probe_kernel(const uint32_t* __restrict__ x,
                                    long long count, int what, int mode,
                                    int n_addrs, float zipf_c,
                                    const int32_t* __restrict__ thr,
                                    int n_thr, int32_t* __restrict__ out) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < count; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint32_t v = x[j];
    out[j] = what == 0   ? static_cast<int32_t>(hash24(v))
           : what == 1   ? jitter(v)
                         : addr_of_hash(v, mode, n_addrs, zipf_c, thr, n_thr);
  }
}

// the serial floor: `per_cycle` block barriers a cycle and no other work
// (each block of a grid on its own)
__global__ void engine_barrier_kernel(int cycles, int per_cycle,
                                      int32_t* sink) {
  __shared__ int32_t s;
  if (threadIdx.x == 0) s = 0;
  __syncthreads();
  for (int cyc = 0; cyc < cycles; ++cyc) {
    for (int j = 0; j < per_cycle; ++j) __syncthreads();
    if (threadIdx.x == 0) s += 1;
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = s;
}

using RunKernel = void (*)(const int32_t*, const RunPtrs*, int);

// the kernel instance, block size and cores a thread of runs of n cores
// (a block of at most 256 threads may use up to 255 registers a thread),
// with every family's branch when kWide, the program code when kProg and
// the topology stages when kTopo
template <bool kWide, bool kProg, bool kTopo, bool kFault>
RunKernel run_kernel_of(int n, int* threads, int* kc) {
  *threads = n <= kRunThreads ? ((n + 31) / 32) * 32 : kRunThreads;
  *kc = (n + *threads - 1) / *threads;
  if (*kc > 2) {
    return engine_run_kernel<GlobalCores, kRunThreads, kWide, kProg, kTopo,
                             kFault>;
  }
  if (*kc == 2) {
    return engine_run_kernel<RegCores<2>, kRunThreads, kWide, kProg, kTopo,
                             kFault>;
  }
  if (*threads <= 256) {
    return engine_run_kernel<RegCores<1>, 256, kWide, kProg, kTopo, kFault>;
  }
  return engine_run_kernel<RegCores<1>, kRunThreads, kWide, kProg, kTopo,
                           kFault>;
}

// the instance `variant` names (kernel.py's INSTANCE_*): 0 without the
// two-level queues' and nb_feb's branches, 1 with them, 2 with them and
// the program code, 3 with them, the program code and the topology
// stages, 4 with all of that and the fault stages; null for another
// value
RunKernel run_kernel_for(int n, int variant, int* threads, int* kc) {
  switch (variant) {
    case 0: return run_kernel_of<false, false, false, false>(n, threads, kc);
    case 1: return run_kernel_of<true, false, false, false>(n, threads, kc);
    case 2: return run_kernel_of<true, true, false, false>(n, threads, kc);
    case 3: return run_kernel_of<true, true, true, false>(n, threads, kc);
    case 4: return run_kernel_of<true, true, true, true>(n, threads, kc);
    default: return nullptr;
  }
}

}  // namespace

// Pointers of a family's absent arrays are null: the bank state of other
// families, and tkt, xval and xmask (ticket_lock's held tickets, the
// per-core write's values and mask) outside the ticket family.  `bank`
// holds the bank-state pointers in BankState's order.
extern "C" int engine_step_launch(
    const void* cand, const void* rot, const void* addr, const void* phase,
    const void* acq_start, void* const* bank, const void* tkt, void* xval,
    void* xmask, void* valid_out, void* win_out, void* kind_out,
    void* tmr_out, void* stats, void* hist, int n, int a, int proto,
    int q_cap, int q_full, int cyc, int shift, int lat, int acq_tmr,
    int wake_delay, int msg_rule, int cycles, int groups, int group_size,
    int group_cap, int local_delay, void* stream) {
  BankState bs;
  static_assert(sizeof(BankState) == 20 * sizeof(void*), "BankState words");
  memcpy(&bs, bank, sizeof(BankState));
  Scalars sc{n, cyc, shift, cycles,
             Family{proto, q_cap, q_full, lat, acq_tmr, wake_delay,
                    msg_rule},
             Groups{groups, group_size, group_cap, local_delay}};
  engine_step_kernel<<<a, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), static_cast<const int32_t*>(rot),
      static_cast<const int32_t*>(addr), static_cast<const int32_t*>(phase),
      static_cast<const int32_t*>(acq_start),
      static_cast<const int32_t*>(tkt), bs, static_cast<int32_t*>(xval),
      static_cast<bool*>(xmask), static_cast<bool*>(valid_out),
      static_cast<int32_t*>(win_out),
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

// Bytes of dynamic shared memory a run of n cores and a banks uses: 0
// when its per-bank state lives in the scratch.  A launch's dynamic
// shared memory is the largest of its runs'.
extern "C" long long engine_run_smem_bytes(int n, int a) {
  const size_t total = run_layout(n, a).total;
  return total <= kMaxDynSmem ? static_cast<long long>(total) : 0;
}

// Threads per block of a run of n cores (the barrier floor's block size).
extern "C" int engine_run_threads(int n) {
  int threads, kc;
  run_kernel_for(n, 0, &threads, &kc);
  return threads;
}

// One launch for `n_runs` runs of n cores each, one block per run.
// `params` is a device array of n_runs x kNumParams int32 words (run b's
// words at b * kNumParams), `ptrs` a device array of n_runs x kNumPtrs
// pointers (run b's RunPtrs); every run's P_N word must be n, and a run
// whose per-bank state does not fit in shared memory must have its own
// scratch (engine_run_scratch_bytes).  `smem` is the launch's dynamic
// shared memory, the largest engine_run_smem_bytes of its runs.
// `variant` picks the kernel instance (run_kernel_for): at least 1 when a
// run's family is kHier, kEvent or kFeb, 2 when a run's program has more
// than one step or a barrier step, 3 when a run has a hierarchical
// topology, 4 when a run has a fault plan.  Returns a CUDA error code, or -1 when
// the caller's layout does not match this library's (n_params, n_ptrs per
// run) or smem or variant is out of range.
extern "C" int engine_run_launch(int n_runs, int n, const void* params,
                                 int n_params, const void* ptrs, int n_ptrs,
                                 long long smem, int variant, void* stream) {
  int threads, kc;
  const RunKernel kern = run_kernel_for(n, variant, &threads, &kc);
  if (n_params != kNumParams || n_ptrs != kNumPtrs || n_runs < 1 || n < 1 ||
      smem < 0 || smem > static_cast<long long>(kMaxDynSmem) ||
      kern == nullptr) {
    return -1;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<n_runs, threads, static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(params),
      static_cast<const RunPtrs*>(ptrs), kc);
  return static_cast<int>(cudaGetLastError());
}

#ifndef CUDA_CPU_MOCK
// What the card gives a launch of runs of n cores with `smem` bytes of
// dynamic shared memory on the instance `variant` picks: out[0] blocks
// resident per SM, out[1] registers a thread, out[2] threads a block,
// out[3] local (spill) bytes a thread.
extern "C" int engine_run_occupancy(int n, long long smem, int variant,
                                    int* out) {
  int threads, kc;
  const RunKernel kern = run_kernel_for(n, variant, &threads, &kc);
  if (kern == nullptr) return -1;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kern, threads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = threads;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
#endif

// what: 0 -> _hash(x), 1 -> the backoff jitter _hash(x) % 32, 2 -> the
// address of hash x in address mode `mode` over n_addrs (skew-0 factor
// zipf_c; a skewed stream's n_thr thresholds at thr, a device array, when
// n_thr > 0).  x and out are device arrays of `count` elements.
extern "C" int engine_probe_launch(const void* x, long long count, int what,
                                   int mode, int n_addrs, float zipf_c,
                                   const void* thr, int n_thr, void* out,
                                   void* stream) {
  engine_probe_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), count, what, mode, n_addrs, zipf_c,
      static_cast<const int32_t*>(thr), n_thr, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// `blocks` blocks of `threads`, each `cycles` cycles of `per_cycle`
// barriers; block b writes its cycle count to sink[b].
extern "C" int engine_barrier_launch(int blocks, int threads, int cycles,
                                     int per_cycle, void* sink,
                                     void* stream) {
  engine_barrier_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cycles, per_cycle, static_cast<int32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
