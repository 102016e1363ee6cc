"""Cycle-level engine of an SPM manycore (MemPool-like), in PyTorch.

The port of ``repro.core.sim``: the same machine model, the same state
and the same arithmetic, bit for bit.

Machine model
-------------
* N cores, A addresses (each contended address lives in its own
  single-ported bank — one request served per bank per cycle).
* A shared request/response network with ``lat``-cycle one-way latency and
  a global bandwidth cap of ``net_bw`` accepted requests per cycle, with
  head-of-line blocking from requests parked at saturated banks.
* Every core runs a per-core **program** owned by a workload plugin
  (``core.workloads``).

Each simulated cycle is one pass of the loop in :func:`simulate`: the
core-side stages (timers, issue, retire, backoff, workers, network
acceptance) are eager torch ops on the run's device, and the bank side
(arbitration, the protocol's bank update, the latency histogram) is one
call of ``kernels.engine_step.fused_step`` — the hand-written CUDA kernel
on a GPU, its plain PyTorch version on the CPU.  All state is int32/bool
tensors; ``cyc`` and the rotation ``shift`` are Python ints, and the loop
never reads a device value back, so the host only queues work.

Scope of the port so far: all eleven of the reference's protocols (the
``amo``/``lrsc``/``lrscwait``/``colibri`` protocols, the
``amo_lock``/``lrsc_lock``/``ticket_lock``/``mwait_lock`` baselines and
the ``colibri_hier``/``hw_event``/``nb_feb`` waiters), through their
fused path, every workload program (the per-core program counter, the
per-step tables and the barrier release of ``ms_queue``,
``treiber_stack`` and ``barrier_phases``), the Zipf stream at every
skew (in a single run's and a sweep's form, as the reference computes
them), every topology (``flat``, and ``cluster2``/``cluster3``: extra
latency at issue, per-level link budgets, the ``hops`` counter), Fig. 5
workers, the per-cycle event traces (``record_trace``), the
windowed telemetry (``telemetry_windows``) and fault injection and
recovery (``faults``: core kills and stalls, request and wakeup drops,
bank stalls, the reservation watchdog and the progress detector; the
empty plan adds no key and no work).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import metrics as metrics_mod
from repro_torch.core import protocols as proto_registry
from repro_torch.core import topologies as topo_registry
from repro_torch.core import workloads as wl_registry
from repro_torch.core.metrics import LAT_BINS
from repro_torch.core.protocols.base import (BACKOFF, BARWAIT, MOD,
                                             NXT_BACKOFF,
                                             NXT_MOD, NXT_WORK_DONE, OUT_DONE,
                                             OUT_EVICT, OUT_FAIL, OUT_GRANT,
                                             OUT_NONE, OUT_SLEEP, P_ACQ,
                                             P_REL, REQ, RESP, SLEEP, WORK,
                                             Ctx)
from repro_torch.core.workloads.base import (ADDR_FIXED, ADDR_ZIPF,
                                             K_BARRIER, zipf_index)
from repro_torch.faults import DROP_DENOM, FaultPlan
from repro_torch.kernels import engine_step
from repro_torch.kernels.engine_step.kernel import shl32
from repro_torch.obs.schema import TELE_K, TELE_NSUM, window_len

#: execution backends.  The port keeps the field so reference JSON loads;
#: the device of the run (``device=``) picks kernel or plain code.
BACKENDS = ("auto",)

#: SimParams fields that may differ between the runs of one sweep chunk
#: (the reference's traced sweep axes, ``repro.core.sim.DYN_FIELDS``)
DYN_FIELDS = ("seed", "n_addrs", "lat", "work", "modify", "backoff",
              "backoff_exp", "net_bw", "hol_block", "n_workers",
              "zipf_skew")

#: int32 sentinel for "no request" in the arbitration
_BIG = 2**31 - 1

_MASK32 = 0xFFFFFFFF
_KNUTH = 2654435761


@dataclasses.dataclass(frozen=True)
class SimParams:
    protocol: str = "colibri"
    workload: str = "rmw_loop"       # per-core program (core.workloads)
    n_cores: int = 256
    # the reference's scan unroll factor; kept so reference JSON
    # loads, and has no effect in the port
    unroll: int = 1
    # kept so reference JSON loads; only "auto" is accepted — the run's
    # device picks the CUDA kernel (GPU) or its plain version (CPU)
    backend: str = "auto"
    n_addrs: int = 1                 # contention: fewer addresses = hotter
    cycles: int = 20_000
    lat: int = 5                     # one-way network latency (cycles)
    work: int = 10                   # local work between atomics
    modify: int = 4                  # cycles between load and store
    # calibrated backoff policy: base 160 with one exponential doubling
    backoff: int = 160               # base retry backoff
    backoff_exp: int = 2             # exponential backoff: cap base<<(exp-1)
    q_slots: int = 256               # lrscwait queue capacity (≥N ⇒ ideal)
    net_bw: int = 64                 # network acceptances per cycle
    # head-of-line blocking: each `hol_block` parked requests occupy one
    # network slot (0 disables) — the Fig. 5 interference mechanism
    hol_block: int = 16
    n_workers: int = 0               # Fig.5: cores streaming a matmul
    seed: int = 0
    n_groups: int = 4                # colibri_hier: clusters of cores
    zipf_skew: int = 100             # 100*s for ADDR_ZIPF streams (s=1.0)
    topology: str = "flat"           # NoC topology (core.topologies)
    clusters: int = 4                # leaf clusters (hierarchical topologies)
    record_trace: bool = False       # event traces (repro_torch.obs)
    telemetry_windows: int = 0       # windowed telemetry (repro_torch.obs)
    faults: FaultPlan = FaultPlan()  # fault injection & recovery

    _BOUNDS = (("n_cores", 1), ("cycles", 1), ("n_addrs", 1),
               ("q_slots", 1), ("n_groups", 1), ("unroll", 1),
               ("backoff_exp", 1), ("net_bw", 1), ("lat", 0),
               ("work", 0), ("modify", 0), ("backoff", 0),
               ("hol_block", 0), ("n_workers", 0), ("zipf_skew", 0),
               ("telemetry_windows", 0), ("clusters", 1))

    def __post_init__(self):
        if self.protocol not in proto_registry.names():
            raise ValueError(
                f"unknown protocol {self.protocol!r}; registered protocols: "
                f"{', '.join(proto_registry.names())}")
        if self.workload not in wl_registry.names():
            raise ValueError(
                f"unknown workload {self.workload!r}; registered workloads: "
                f"{', '.join(wl_registry.names())}")
        if self.topology not in topo_registry.names():
            raise ValueError(
                f"unknown topology {self.topology!r}; registered topologies: "
                f"{', '.join(topo_registry.names())}")
        for fname, lo in self._BOUNDS:
            v = getattr(self, fname)
            if (not isinstance(v, (int, np.integer))
                    or isinstance(v, bool) or v < lo):
                raise ValueError(
                    f"{fname} must be an int >= {lo} (got {v!r})")
        if not isinstance(self.seed, (int, np.integer)) \
                or isinstance(self.seed, bool):
            raise ValueError(f"seed must be an int (got {self.seed!r})")
        if not isinstance(self.record_trace, (bool, np.bool_)):
            raise ValueError(
                f"record_trace must be a bool (got {self.record_trace!r})")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; the port accepts: "
                f"{', '.join(BACKENDS)} (the run's device picks the CUDA "
                f"kernel or its plain version)")
        if self.faults is None:
            object.__setattr__(self, "faults", FaultPlan())
        elif isinstance(self.faults, dict):
            object.__setattr__(self, "faults", FaultPlan(**self.faults))
        elif not isinstance(self.faults, FaultPlan):
            raise ValueError(
                f"faults must be a FaultPlan, a dict or None "
                f"(got {self.faults!r})")
        wl = wl_registry.get(self.workload)
        if self.n_addrs < wl.min_addrs:
            raise ValueError(
                f"workload {self.workload!r} needs n_addrs >= "
                f"{wl.min_addrs} (got {self.n_addrs})")


def _hash(x: torch.Tensor) -> torch.Tensor:
    """Cheap counter-based pseudo-random (Knuth multiplicative), exactly
    the reference's ``(x.astype(uint32) * 2654435761) >> 8``.

    ``x`` is an int64 tensor holding the exact value of the reference's
    int32 expression; masking to 32 bits equals its int32 wrap followed
    by the uint32 cast.  The uint32 multiply is done in int64 on the
    constant's two 16-bit halves, so no int64 product can overflow.
    """
    x = x & _MASK32
    lo = x * (_KNUTH & 0xFFFF)
    hi = ((x * (_KNUTH >> 16)) & 0xFFFF) << 16
    return ((lo + hi) & _MASK32) >> 8


def accept_rotating_fair(all_req: torch.Tensor, budget,
                         shift: int) -> torch.Tensor:
    """Accept the ``budget`` requesters with the lowest rotated priority
    ``rot = (iota + shift) % n``.

    Laying the request mask out in rot-space (a ``torch.roll`` by
    ``shift``) and taking a cumulative sum yields each requester's exact
    rank among requesters.
    """
    req_by_rot = torch.roll(all_req.to(torch.int32), shift)
    rank = torch.roll(torch.cumsum(req_by_rot, 0, dtype=torch.int32),
                      -shift) - 1
    return all_req & (rank < budget)


def resolve_device(device=None) -> torch.device:
    """The run's device: ``None`` means ``"cuda"``, and a CUDA run
    without a visible GPU raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU, and torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev


def simulate(p: SimParams, device) -> Dict[str, torch.Tensor]:
    """One engine run on ``device``: the reference's flat result dict
    (per-core and per-bank arrays, scalar counters, the protocol's bank
    state), as tensors on that device.  On a GPU the whole run is one
    launch of the ``engine_run`` CUDA kernel (``engine_step.run_cuda``);
    elsewhere it is the plain loop, :func:`_simulate_plain`."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return engine_step.run_cuda(p, proto_registry.get(p.protocol),
                                    wl_registry.get(p.workload).program(p),
                                    dev)
    return _simulate_plain(p, dev)


def _bucket_a(n_addrs: int) -> int:
    """Bank-allocation bucket of a swept point: the next power of two
    ≥ ``n_addrs`` (the reference's ``repro.core.sweep._bucket_a``, so a
    swept point's bank arrays have its shapes)."""
    return 1 << max(n_addrs - 1, 0).bit_length()


def _scatter_at_wakes(dst: torch.Tensor, woken: torch.Tensor,
                      addr: torch.Tensor, vals) -> torch.Tensor:
    """``dst`` (a,) with each woken core's bank set to that core's entry
    of ``vals`` (n,) — the reference's ``dst.at[where(woken, addr,
    a)].set(vals)``.  A cycle wakes at most one core a bank (each bank
    wakes its queue's head), so no bank is written twice."""
    a = dst.shape[0]
    out = torch.cat([dst, dst.new_zeros(1)])
    out.scatter_(0, torch.where(woken, addr, a).to(torch.int64), vals)
    return out[:a]


def simulate_batch(points: Sequence[SimParams], device, started=None
                   ) -> List[Dict[str, torch.Tensor]]:
    """Many engine runs on ``device``: one result dict per point, in
    order, each what :func:`simulate` gives for that point except that
    its bank arrays (``addr_ops``, the protocol's bank state and
    ``trace_qlen``'s columns) have the power-of-two bucket of its
    ``n_addrs`` (:func:`_bucket_a`) as rows, as in the
    reference's sweep: the padded banks see no request and keep their
    initial state.  On a GPU the points of one core count are ONE
    launch of the ``engine_run`` kernel (``engine_step.run_cuda_batch``,
    every tensor of a launch a view of one flat buffer); on the CPU each
    point is the plain loop, :func:`_simulate_plain`, at the bucket.
    A skewed Zipf stream takes the reference sweep's form (its traced
    scalars, ``zipf_index(..., traced=True)``), which differs from a
    single run's on a few hashes; a bank stall's victims are drawn
    over the bucket, as the reference's sweep draws them over its bank
    allocation, so they may differ from a single run's too.
    ``started``, a CUDA event, is recorded when the host has packed the
    first launch, before the card's work (GPU only)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [_simulate_plain(p, dev, banks=_bucket_a(p.n_addrs),
                                traced=True)
                for p in points]
    groups: Dict[int, List[int]] = {}
    for i, p in enumerate(points):
        groups.setdefault(p.n_cores, []).append(i)
    out: List[Dict[str, torch.Tensor]] = [None] * len(points)  # type: ignore
    for idxs in groups.values():
        runs = [(points[i], proto_registry.get(points[i].protocol),
                 wl_registry.get(points[i].workload).program(points[i]),
                 _bucket_a(points[i].n_addrs)) for i in idxs]
        for i, res in zip(idxs, engine_step.run_cuda_batch(
                runs, dev, started, traced=True)):
            out[i] = res
        started = None
    return out


def _simulate_plain(p: SimParams, device, banks=None, traced=False
                    ) -> Dict[str, torch.Tensor]:
    """The plain version of a run: one pass of an eager loop per
    simulated cycle, its bank side through ``engine_step.fused_step``
    (one launch of the per-cycle CUDA kernel a cycle on a GPU, its plain
    version on the CPU).  It is what ``simulate`` runs on the CPU, and
    what the ``engine_run`` kernel is held against on the card.
    ``banks`` (default ``p.n_addrs``) is the number of banks allocated;
    addresses are drawn over ``p.n_addrs``.  ``traced`` picks the
    sweep's form of a skewed Zipf stream (``zipf_index``).  A
    hierarchical topology's tables are compiled at ``banks``, as the
    reference's sweep compiles them at its bank allocation."""
    dev = torch.device(device)
    i32 = torch.int32
    proto = proto_registry.get(p.protocol)
    prog = wl_registry.get(p.workload).program(p)
    pt = prog.tables()
    n, a = p.n_cores, (p.n_addrs if banks is None else banks)
    q_cap = proto.q_cap(p, n)
    exp_cap = 1 if proto.fixed_backoff else p.backoff_exp
    # the step tables: local work and modify durations, address modes
    # and fixed addresses, one entry per step
    L = prog.length
    pre_tab = [int(pt["pre_mult"][j]) * p.work + int(pt["pre_add"][j])
               for j in range(L)]
    mod_tab = [int(pt["mod_mult"][j]) * p.modify + int(pt["mod_add"][j])
               for j in range(L)]
    modes = [int(m) for m in pt["addr_mode"]]
    fix_tab = [(int(x) & _MASK32) % p.n_addrs for x in pt["addr_arg"]]
    has_bar = K_BARRIER in prog.kind
    # decided once per run, as use_tele is: a one-step barrier-free
    # program folds every table entry to a constant and keeps no program
    # counter, so it issues no tensor op a cycle for what it does not run
    use_pc = L > 1 or has_bar
    # the NoC topology: per-(core, bank) extra latency, hop counts and
    # level crossings, flattened so a cycle gathers one lane a core at
    # ``core * a + addr``; flat compiles to no tables and no stage
    topo = topo_registry.get(p.topology)
    tt = topo.tables(p, n, a)
    use_topo = not tt.is_flat

    def zeros(shape=(), dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def table(vals, dtype=i32):
        return torch.tensor(vals, dtype=dtype, device=dev)

    iota = torch.arange(n, dtype=i32, device=dev)
    if use_topo:
        lane0 = iota.to(torch.int64) * a
        extra_t = torch.from_numpy(tt.extra.reshape(-1)).to(dev)
        hops_t = torch.from_numpy(tt.hops.reshape(-1)).to(dev)
        cross_t = [torch.from_numpy(x.reshape(-1)).to(dev) for x in tt.cross]
        lvl_bw = [max(p.net_bw // lv.bw_div, 1) for lv in topo.levels]
        hops = zeros()
    hash_base = iota.to(torch.int64) * 7919 + p.seed
    # backoff jitter ``_hash(core + cyc) % 32`` for every (core, cycle):
    # one table over [0, cycles + n), read per cycle as a slice
    jitter = (_hash(torch.arange(p.cycles + n, dtype=torch.int64,
                                 device=dev)) % 32).to(i32)
    ba = torch.arange(a, dtype=i32, device=dev)
    # backoff base per failure streak: backoff << max(streak - 1, 0)
    bo_tab = torch.tensor([shl32(p.backoff, max(k - 1, 0))
                           for k in range(exp_cap + 1)], dtype=i32,
                          device=dev)
    has_workers = p.n_workers > 0
    is_worker = iota < p.n_workers
    not_worker = ~is_worker
    n_atomic = n - min(p.n_workers, n)

    st = torch.full((n,), WORK, dtype=i32, device=dev)
    tmr = (iota * 3) % (p.work + 1)                       # stagger
    addr, phase, nxt = zeros(n), zeros(n), zeros(n)
    arr_cyc = torch.full((n,), -1, dtype=i32, device=dev)
    parked = zeros(n, torch.bool)
    resp_prev = zeros()
    opc, streak, acq_start = zeros(n), zeros(n), zeros(n)
    bank = proto.init_bank_state(p, a, n, q_cap, dev)
    xc = proto.init_core_state(p, n, dev)
    msgs, polls, sleep_cyc, lat_max = zeros(), zeros(), zeros(), zeros()
    backoff_cyc, active_cyc, bank_ops, net_stall = (zeros(), zeros(),
                                                    zeros(), zeros())
    addr_ops, lat_hist = zeros(a), zeros(LAT_BINS)
    w_tmr, w_served = zeros(n), zeros(n)
    if use_pc:
        pc, bar_cnt, ops, bar_cyc = zeros(n), zeros(n), zeros(n), zeros()
        pre_t, mod_t, fix_t = table(pre_tab), table(mod_tab), table(fix_tab)
        mode_t = table(modes)
        next_t = table([(j + 1) % L for j in range(L)])
        is_bar_t = table([k == K_BARRIER for k in prog.kind], torch.bool)
        mod_dur = mod_t[pc]
    else:
        pre_dur, mod_dur = pre_tab[0], mod_tab[0]
    # observability (repro_torch.obs): decided once per run, so with
    # both features off the loop issues exactly the ops it would without
    # them and the result dict has none of their keys
    use_tele, use_trace = p.telemetry_windows > 0, p.record_trace
    if use_tele or use_trace:
        no_queue = zeros(a)              # queue depth of queueless banks
    if use_tele:
        tele = zeros((p.telemetry_windows, TELE_K))
        tele_cw = window_len(p.cycles, p.telemetry_windows)
        zero = zeros()          # xcl_msgs (flat); barwait without bars
    if use_trace:
        if use_pc:
            trace_step = zeros((p.cycles, n))
        trace_wait = zeros((p.cycles, n))
        trace_state = zeros((p.cycles, n), torch.int8)
        trace_qlen = zeros((p.cycles, a))
        no_retire = torch.full((), -1, dtype=i32, device=dev)
    ctx = Ctx(p=p, n=n, a=a, q_cap=q_cap, ba=ba,
              mod_dur=(mod_dur if use_pc else
                       torch.full((n,), mod_dur, dtype=i32, device=dev)))
    # the engine's OUT_* -> (st, nxt) apply as lookup tables over the
    # five codes: GRANT/DONE/FAIL answer with RESP and NXT_MOD /
    # NXT_WORK_DONE / NXT_BACKOFF; SLEEP parks the core; NONE is no-op
    kinds = (OUT_NONE, OUT_GRANT, OUT_DONE, OUT_FAIL, OUT_SLEEP)
    resp_of_kind = torch.tensor([k in (OUT_GRANT, OUT_DONE, OUT_FAIL)
                                 for k in kinds], device=dev)
    nxt_of_kind = torch.tensor(
        [NXT_MOD if k == OUT_GRANT else NXT_WORK_DONE if k == OUT_DONE
         else NXT_BACKOFF for k in kinds], dtype=i32, device=dev)
    # ---- fault injection & recovery: decided once per run, so the empty
    # plan issues no op and adds no key.  The victim sets are drawn on the
    # host from the plan's seed (the bank-stall victims over the banks
    # allocated); only a holder kill chooses its victims in the loop
    fp = p.faults
    use_faults = fp.enabled
    holder_mode = use_faults and fp.n_kill > 0 and fp.kill_holder == 1
    uni_kill = use_faults and fp.n_kill > 0 and fp.kill_holder == 0
    has_stall = use_faults and fp.n_stall > 0
    has_bstall = use_faults and fp.n_bank_stall > 0
    has_drop = use_faults and fp.msg_drop_bp > 0
    any_core_fault = holder_mode or uni_kill or has_stall
    use_wd = (use_faults and fp.watchdog_cyc > 0
              and proto.held(bank) is not None)
    if use_faults:
        no_core = zeros(n, torch.bool)
        if uni_kill:
            kill_m = torch.from_numpy(fp.kill_mask(n)).to(dev)
        if has_stall:
            stall_m = torch.from_numpy(fp.stall_mask(n)).to(dev)
        if has_bstall:
            bstall_m = torch.from_numpy(fp.bank_stall_mask(a)).to(dev)
        prog_thr = fp.progress_threshold()
        finj, last_ret = zeros(), zeros()
        halt_cyc = torch.full((), -1, dtype=i32, device=dev)
        if holder_mode:
            kmask = zeros(n, torch.bool)
            kleft = torch.full((), fp.n_kill, dtype=i32, device=dev)
        if use_wd:
            wd_srv, recoveries = zeros(a), zeros()
            wd_own = torch.full((a,), n, dtype=i32, device=dev)
        if has_drop:
            # the Bernoulli streams' per-lane terms (the cycle's is added
            # each cycle): requests by core, lost wakeups by bank
            drop_base = (iota.to(torch.int64) * 9781
                         + fp.fault_seed * 977 + 13)
            wdrop_base = (ba.to(torch.int64) * 3643
                          + fp.fault_seed * 389 + 7)

    def stream(opc, mode):
        """The uniform counter hash or the Zipf stream at ``opc``."""
        h = _hash(hash_base + opc.to(torch.int64) * 104729)
        if mode == ADDR_ZIPF:
            return zipf_index(h, p.n_addrs, p.zipf_skew, traced)
        return (h % p.n_addrs).to(i32)                  # ADDR_UNIFORM

    def step_addr(opc, pc):
        """Current micro-op's target address: its step's fixed address
        or stream (``pc`` None: the one step of a one-step program)."""
        if pc is None:
            if modes[0] == ADDR_FIXED:
                return torch.full((n,), fix_tab[0], dtype=i32, device=dev)
            return stream(opc, modes[0])
        out = fix_t[pc]
        for mode in sorted(set(modes) - {ADDR_FIXED}):
            out = torch.where(mode_t[pc] == mode, stream(opc, mode), out)
        return out

    for cyc in range(p.cycles):
        # ---- timers ----
        tmr = (tmr - 1).clamp_(min=0)
        t0 = tmr == 0

        # ---- faults: dead (killed, or inside a stall window) cores
        # freeze — their timers never fire, they send nothing — while
        # their requests already in flight are still served ----
        if any_core_fault:
            if holder_mode:
                killed = kmask
            elif uni_kill and cyc >= fp.kill_cyc:
                killed = kill_m
            else:
                killed = no_core
            dead = killed
            if has_stall and fp.stall_cyc <= cyc < fp.stall_cyc \
                    + fp.stall_dur:
                dead = dead | stall_m
            t0 = t0 & ~dead
        if use_faults:
            if uni_kill and cyc == fp.kill_cyc:
                finj = finj + min(fp.n_kill, n)
            if has_stall and cyc == fp.stall_cyc:
                finj = finj + min(fp.n_stall, n)
            if has_bstall and cyc == fp.bank_stall_cyc:
                finj = finj + min(fp.n_bank_stall, a)

        # ---- timer-expiry dispatch: WORK -> acquire, BACKOFF ->
        # reissue acquire, MOD -> release/SC ----
        start = t0 & (st == WORK)
        if has_workers:
            start = start & not_worker
        rb = t0 & (st == BACKOFF)
        md = t0 & (st == MOD)
        issue = start | rb | md
        addr = torch.where(start, step_addr(opc, pc if use_pc else None),
                           addr)
        phase = phase.masked_fill(start | rb, P_ACQ).masked_fill_(md, P_REL)
        st = st.masked_fill(issue, REQ)
        if use_topo:
            # a request crossing cluster levels pays their extra latency
            # once per issue, before the network and bank stages
            tmr = torch.where(issue, p.lat + extra_t[lane0 + addr], tmr)
        else:
            tmr = tmr.masked_fill_(issue, p.lat)

        # ---- RESP arrives: the current micro-op retires ----
        ra = t0 & (st == RESP)
        done = ra & (nxt == NXT_WORK_DONE)
        if use_pc:
            # a retiring barrier step parks at the barrier, any other
            # goes to the next step's local work; the program counter
            # wraps to 0 once per completed op
            pc_done = pc
            go_work = done
            if has_bar:
                at_bar = done & is_bar_t[pc]
                go_work = done & ~at_bar
                bar_cnt = bar_cnt + at_bar
                st = st.masked_fill_(at_bar, BARWAIT)
            st = st.masked_fill_(go_work, WORK)
            pc = torch.where(done, next_t[pc], pc)
            ops = ops + (done & (pc == 0))
            pre_dur = pre_t[pc]
            mod_dur = ctx.mod_dur = mod_t[pc]
            tmr = torch.where(go_work, pre_dur, tmr)
        else:
            st = st.masked_fill_(done, WORK)
            tmr = tmr.masked_fill_(done, pre_dur)
        opc = opc + done
        acq_start = acq_start.masked_fill(start, cyc)
        addr_ops = addr_ops.index_add(0, addr, done.to(i32))
        to_mod = ra & (nxt == NXT_MOD)
        st = st.masked_fill_(to_mod, MOD)
        tmr = (torch.where(to_mod, mod_dur, tmr) if use_pc
               else tmr.masked_fill_(to_mod, mod_dur))
        to_bo = ra & (nxt == NXT_BACKOFF)
        st = st.masked_fill_(to_bo, BACKOFF)
        streak = torch.where(to_bo, (streak + 1).clamp_(max=exp_cap),
                             streak.masked_fill(done, 0))
        bo_len = bo_tab[streak] + jitter[cyc:cyc + n]
        tmr = torch.where(to_bo, bo_len, tmr)

        # ---- barrier: the last arrival releases every waiter, one wake
        # message each, after one response latency ----
        if has_bar:
            min_bar = (bar_cnt.masked_fill(is_worker, _BIG) if has_workers
                       else bar_cnt).min()
            rel = (st == BARWAIT) & (bar_cnt <= min_bar)
            st = st.masked_fill_(rel, WORK)
            tmr = torch.where(rel, pre_dur + p.lat, tmr)
            bar_msgs = rel.sum(dtype=i32)

        # ---- workers stream loads (Fig. 5) ----
        if has_workers:
            w_tmr = (w_tmr - 1).clamp_(min=0)
            w_arr = is_worker & (w_tmr == 0)
            if any_core_fault:
                w_arr = w_arr & ~dead            # dead workers go silent

        # ---- network acceptance (rotating-fair, bounded bandwidth) ----
        fresh = (st == REQ) & (tmr == 0) & ~parked
        if has_workers:
            fresh = fresh & not_worker
        if any_core_fault:
            fresh = fresh & ~dead                # dead cores stop sending
        shift = (cyc * 97) % n
        rot = torch.roll(iota, -shift)                    # (iota+shift)%n
        all_req = (fresh | w_arr) if has_workers else fresh
        hol = (parked.sum(dtype=i32) // p.hol_block) if p.hol_block else 0
        budget = (p.net_bw - resp_prev - hol).clamp_(min=1)
        accepted = accept_rotating_fair(all_req, budget, shift)
        if use_topo:
            # a request crossing level l also needs one of that level's
            # link slots this cycle (the same rotating-fair arbiter over
            # the crossing requesters); workers' loads stay local
            lane = lane0 + addr
            xmask = [x[lane] & not_worker for x in cross_t]
            for cm, bw in zip(xmask, lvl_bw):
                acc_x = accept_rotating_fair(all_req & cm, bw, shift)
                accepted = accepted & (~cm | acc_x)
        if has_drop:
            # Bernoulli drop of newly accepted requests: the message dies
            # in flight and the core retransmits next cycle; the wasted
            # hop is billed into msgs
            u = _hash(drop_base + cyc * 6271)
            req_drop = (fresh & accepted
                        & ((u % DROP_DENOM) < fp.msg_drop_bp))
            accepted = accepted & ~req_drop
            n_req_drop = req_drop.sum(dtype=i32)
            finj = finj + n_req_drop
        if has_workers:
            w_acc = w_arr & accepted
            w_served = w_served + w_acc
            w_tmr = w_tmr.masked_fill_(w_acc, 2)
            w_tmr = w_tmr.masked_fill_(is_worker & (w_tmr == 0), 1)
        stall_now = (all_req & ~accepted).sum(dtype=i32)
        net_stall = net_stall + stall_now
        new_acc = fresh & accepted
        parked = parked | new_acc
        arr_cyc = arr_cyc.masked_fill(new_acc, cyc)
        if use_topo:
            # every accepted request crosses its hop path twice (request
            # and response); a worker's load is a one-hop round trip
            hop_now = torch.where(new_acc, hops_t[lane], 0).sum(dtype=i32)
            if has_workers:
                hop_now = hop_now + w_acc.sum(dtype=i32)
            hops = hops + 2 * hop_now

        # ---- bank side: arbitration + protocol + histogram ----
        arrived = parked & (st == REQ)
        if has_bstall and fp.bank_stall_cyc <= cyc < fp.bank_stall_cyc \
                + fp.bank_stall_dur:
            # a stalled bank takes no request; its parked ones wait
            arrived = arrived & ~bstall_m[addr]
        fs = engine_step.fused_step(
            proto, p, bank, cand_cyc=arr_cyc.masked_fill(~arrived, _BIG),
            rot=rot, addr=addr, phase=phase, acq_start=acq_start,
            core={f: xc[f] for f in proto.fused_core_fields},
            cyc=cyc, shift=shift, lat=p.lat, n=n, a=a, q_cap=q_cap,
            cycles=p.cycles)
        # apply the per-bank outcome codes to the winning cores.  A
        # bank's winner was chosen among the cores whose addr is that
        # bank, so gathering the bank lanes at ``addr`` reaches exactly
        # the reference's scatter targets (no index is written twice)
        winner = fs["win"][addr] == iota
        parked = parked & ~winner
        arr_cyc = arr_cyc.masked_fill_(winner, -1)
        kind_c = fs["kind"][addr]
        resp_c = winner & resp_of_kind[kind_c]
        st = st.masked_fill_(resp_c, RESP)
        st = st.masked_fill_(winner & (kind_c == OUT_SLEEP), SLEEP)
        tmr = torch.where(resp_c, fs["tmr"][addr], tmr)
        nxt = torch.where(resp_c, nxt_of_kind[kind_c], nxt)
        # the protocol's per-core writes (the ticket lock's drawn or
        # dropped ticket), (values, mask) per bank, at the winning cores
        for f in proto.fused_xset_fields:
            val, msk = fs["xset"][f]
            xc[f] = torch.where(winner & msk[addr], val[addr], xc[f])
        n_win = winner.sum(dtype=i32)
        polls = polls + fs["polls"]
        # side messages: the protocol's, the barrier release's and the
        # watchdog's recoveries (they take network slots next cycle)
        xmsgs = fs["msgs"]
        if has_bar:
            xmsgs = xmsgs + bar_msgs
        bank = fs["bank"]
        bank_ops = bank_ops + n_win
        if use_tele:
            # bank-access outcome tallies, before wake-ups
            oc = engine_step.outcome_counts(fs["kind"])
        if use_tele or use_wd or holder_mode:
            st_pre_wake = st

        # ---- wakeups (queue-based protocols) ----
        wake_load = 0
        if proto.uses_queue and has_drop:
            # lost wakeup: a wake message firing this cycle drops; the
            # sleeping head never hears it (only the watchdog recovers)
            wt = bank["wake_tmr"]
            uw = _hash(wdrop_base + cyc * 9176)
            wdrop = (wt == 1) & ((uw % DROP_DENOM) < fp.msg_drop_bp)
            bank = dict(bank, wake_tmr=wt.masked_fill(wdrop, 0))
            finj = finj + wdrop.sum(dtype=i32)
        if proto.uses_queue:
            cs, bank, wake_load = proto.on_wake(ctx, dict(st=st, tmr=tmr),
                                                bank)
            st, tmr = cs["st"], cs["tmr"]

        # ---- fault recovery: holder kills, the reservation watchdog ----
        if holder_mode or use_wd:
            # a woken core is handed ownership as much as a granted one
            woken = ((st_pre_wake == SLEEP) & (st != SLEEP)
                     if proto.uses_queue else no_core)
        if holder_mode and cyc >= fp.kill_cyc:
            # the first kleft cores, by core index, handed ownership (a
            # bank grant or a wake) at or after kill_cyc die holding it
            cand = ((winner & (kind_c == OUT_GRANT)) | woken) & ~kmask
            rank = torch.cumsum(cand.to(i32), 0, dtype=i32) - 1
            newk = cand & (rank < kleft)
            kmask = killed = kmask | newk
            n_newk = newk.sum(dtype=i32)
            kleft = kleft - n_newk
            finj = finj + n_newk
        if use_wd:
            # per-bank service timer, re-armed by every sign of life (not
            # held, a retire, a wake hand-off) but not by grants
            held_b = proto.held(bank)
            wd_own = torch.where(fs["kind"] == OUT_GRANT, fs["win"], wd_own)
            wd_own = _scatter_at_wakes(wd_own, woken, addr, iota)
            wd_srv = wd_srv.masked_fill(~held_b | (fs["kind"] == OUT_DONE),
                                        cyc)
            wd_srv = _scatter_at_wakes(wd_srv, woken, addr,
                                       torch.full_like(iota, cyc))
            stuck_b = held_b & (cyc - wd_srv >= fp.watchdog_cyc)
            tcs, bank, rkind = proto.on_timeout(
                ctx, dict(msgs=zeros()), bank, stuck_b,
                killed if holder_mode or uni_kill else no_core, wd_own)
            xmsgs = xmsgs + tcs["msgs"]
            recoveries = recoveries + (rkind != OUT_NONE).sum(dtype=i32)
            wd_srv = wd_srv.masked_fill(stuck_b, cyc)          # re-arm
            # an eviction vacates the bank: forget the owner (the next
            # grant or wake re-learns it)
            wd_own = wd_own.masked_fill(rkind == OUT_EVICT, n)
        if use_faults:
            # forward-progress detector: no retirement anywhere for
            # prog_thr cycles flags the halt cycle
            last_ret = torch.where(done.any(), cyc, last_ret)
            halt_cyc = torch.where(
                (halt_cyc < 0) & (cyc - last_ret >= prog_thr), cyc,
                halt_cyc)
        msgs_now = 2 * n_win + xmsgs
        if has_drop:
            # a dropped request crossed the network once before dying
            # (billed, but it takes no response slot)
            msgs_now = msgs_now + n_req_drop
        msgs = msgs + msgs_now

        # ---- completion-latency histogram (accumulated in the kernel)
        lat_hist = lat_hist + fs["hist"]
        lat_max = torch.maximum(lat_max, fs["lat_max"])
        # network slots taken next cycle by this cycle's responses,
        # worker loads, protocol side-messages, wake-ups and barrier
        # releases
        resp_prev = n_win + xmsgs + wake_load
        if has_workers:
            resp_prev = resp_prev + w_acc.sum(dtype=i32)
        # ---- per-cycle state census ----
        sleep_now = (st == SLEEP).sum(dtype=i32)
        sleep_cyc = sleep_cyc + sleep_now
        backoff_now = (st == BACKOFF).sum(dtype=i32)
        backoff_cyc = backoff_cyc + backoff_now
        if has_bar:
            bar_now = (st == BARWAIT).sum(dtype=i32)
            bar_cyc = bar_cyc + bar_now
        if has_workers:
            awake = st != SLEEP
            if has_bar:
                awake = awake & (st != BARWAIT)
            active_now = (awake & not_worker).sum(dtype=i32)
        else:
            # workers are never asleep nor at a barrier: active = the
            # atomic cores neither asleep nor at a barrier
            active_now = n_atomic - sleep_now
            if has_bar:
                active_now = active_now - bar_now
        active_cyc = active_cyc + active_now

        # ---- observability: end-of-cycle queue depths (after on_wake),
        # one telemetry window row, one trace row ----
        if use_tele or use_trace:
            qd = proto.queue_depth(bank)
            qd = no_queue if qd is None else qd.to(i32)
        if use_tele:
            wakes = (((st_pre_wake == SLEEP) & (st != SLEEP)).sum(dtype=i32)
                     if proto.uses_queue else zero)
            # accepted requests, split by whether their path crosses the
            # leaf-cluster boundary (flat: every one is local)
            acc_all = accepted.sum(dtype=i32)
            xcl_now = ((accepted & xmask[0]).sum(dtype=i32) if use_topo
                       else zero)
            row = torch.stack([
                active_now, sleep_now, backoff_now,
                bar_now if has_bar else zero, oc["grants"],
                oc["retires"], oc["fails"], oc["enqueues"], wakes, msgs_now,
                stall_now, acc_all - xcl_now, xcl_now,
                qd.sum(dtype=i32)])
            tw = tele[cyc // tele_cw]
            tw[:TELE_NSUM] += row
            tw[TELE_NSUM:].clamp_(min=qd.max())      # queue_max
        if use_trace:
            if use_pc:
                torch.where(done, pc_done, no_retire, out=trace_step[cyc])
            torch.where(done, cyc - acq_start, no_retire,
                        out=trace_wait[cyc])
            trace_state[cyc].copy_(st)
            trace_qlen[cyc].copy_(qd)

    if not use_pc:
        pc, bar_cnt, ops, bar_cyc = zeros(n), zeros(n), opc.clone(), zeros()
    out = dict(st=st, tmr=tmr, addr=addr, phase=phase, nxt=nxt,
               pc=pc, bar_cnt=bar_cnt, opc=opc, arr_cyc=arr_cyc,
               streak=streak, parked=parked, resp_prev=resp_prev, ops=ops,
               acq_start=acq_start, msgs=msgs, polls=polls,
               addr_ops=addr_ops, sleep_cyc=sleep_cyc, bar_cyc=bar_cyc,
               lat_hist=lat_hist, lat_max=lat_max, active_cyc=active_cyc,
               backoff_cyc=backoff_cyc, bank_ops=bank_ops,
               net_stall=net_stall, w_tmr=w_tmr, w_served=w_served)
    if use_topo:
        out["hops"] = hops
    if use_tele:
        out["tele"] = tele
    out.update(bank)
    out.update(xc)
    if use_faults:
        out.update(faults_injected=finj, last_ret=last_ret,
                   halt_cyc=halt_cyc)
        if holder_mode:
            out.update(kmask=kmask, kleft=kleft)
        # the cores dead at the horizon, for the survivor metrics
        dm = kmask if holder_mode else no_core
        if uni_kill and fp.kill_cyc < p.cycles:
            dm = dm | kill_m
        if has_stall and (fp.stall_cyc <= p.cycles - 1
                          < fp.stall_cyc + fp.stall_dur):
            dm = dm | stall_m
        if use_wd:
            out.update(wd_srv=wd_srv, wd_own=wd_own)
        out.update(recoveries=recoveries if use_wd else zeros(),
                   dead_mask=dm)
    if use_trace:
        # the retired micro-op's pre-advance program counter where a core
        # retired, else -1 (0 in a one-step program)
        if not use_pc:
            trace_step = (trace_wait >= 0).to(i32) - 1
        out["trace_step"] = trace_step
        out["trace_wait"] = trace_wait
        out["trace_state"] = trace_state
        out["trace_qlen"] = trace_qlen
    return out


#: numpy dtype of each result dtype (the host copy's views)
_NP_DTYPE = {torch.int32: np.dtype(np.int32), torch.int8: np.dtype(np.int8),
             torch.bool: np.dtype(np.bool_)}


class HostCopy:
    """Result dicts' copy to the host, maybe still in flight; :meth:`wait`
    gives them as numpy dicts (views of the copy)."""

    def __init__(self, outs, where=None, done=None, started=None):
        self.outs, self.where = outs, where
        self.done, self.started = done, started

    def wait(self) -> List[Dict[str, np.ndarray]]:
        if self.where is None:                      # CPU tensors
            return [{k: t.numpy() for k, t in out.items()}
                    for out in self.outs]
        if self.done is not None:
            self.done.synchronize()
        res = []
        for out, where in zip(self.outs, self.where):
            row = {}
            for k, t in out.items():
                host, lo = where[k]
                dt = _NP_DTYPE[t.dtype]
                row[k] = host[lo:lo + t.numel() * dt.itemsize].view(
                    dt).reshape(t.shape)
            res.append(row)
        return res

    def seconds(self) -> float:
        """Card seconds from ``started`` to the end of the copy (0.0
        without both events)."""
        if self.done is None or self.started is None:
            return 0.0
        return self.started.elapsed_time(self.done) / 1e3


def to_host(outs: List[Dict[str, torch.Tensor]], started=None,
            pinned: bool = False) -> HostCopy:
    """Copy result dicts of GPU tensors to the host in ONE copy per
    distinct buffer they are views of (``simulate_batch``'s, and a
    single run's, are views of one flat buffer): the span from the first
    to the last byte they hold.  With ``pinned`` the copy goes into
    pinned memory, queued on the stream behind the work before it, and
    the host waits only in :meth:`HostCopy.wait` (``started``, a CUDA
    event recorded before that work, times it); else it is a plain
    synchronous copy.  CPU tensors are already on the host."""
    if not outs or next(iter(outs[0].values())).device.type != "cuda":
        return HostCopy(outs)
    spans: Dict[int, list] = {}
    for out in outs:
        for t in out.values():
            base = t if t._base is None else t._base
            lo = t.data_ptr() - base.data_ptr()
            span = spans.setdefault(base.data_ptr(), [base, lo, lo, None])
            span[1] = min(span[1], lo)
            span[2] = max(span[2], lo + t.numel() * t.element_size())
    for span in spans.values():
        base, lo, hi, _ = span
        host = torch.empty(hi - lo, dtype=torch.uint8, pin_memory=pinned)
        host.copy_(base.reshape(-1).view(torch.uint8)[lo:hi],
                   non_blocking=pinned)
        span[3] = host.numpy()
    where = []
    for out in outs:
        w = {}
        for k, t in out.items():
            base = t if t._base is None else t._base
            _, lo, _, host = spans[base.data_ptr()]
            w[k] = (host, t.data_ptr() - base.data_ptr() - lo)
        where.append(w)
    done = None
    if pinned:
        done = torch.cuda.Event(enable_timing=started is not None)
        done.record()
    return HostCopy(outs, where, done, started)


def derive_metrics(res: Dict[str, np.ndarray], n_workers: int, cycles: int,
                   energy_fit=None) -> Dict[str, np.ndarray]:
    """Attach the paper's metric set to a raw numpy result dict (alias
    for :func:`repro_torch.core.metrics.attach`)."""
    return metrics_mod.attach(res, n_workers, cycles, fit=energy_fit)


def execute(p: SimParams, energy_fit=None, device=None
            ) -> Dict[str, np.ndarray]:
    """Run one configuration on ``device`` (default ``"cuda"``) and
    return the metric-annotated result dict as numpy arrays.  Internal
    entry point: the public surface is :func:`repro_torch.sync.run`."""
    res = to_host([simulate(p, resolve_device(device))]).wait()[0]
    return derive_metrics(res, min(p.n_workers, p.n_cores), p.cycles,
                          energy_fit=energy_fit)


def run(p: SimParams, energy_fit=None, device=None) -> Dict[str, np.ndarray]:
    """Deprecated legacy entry point — use ``repro_torch.sync.run``."""
    warnings.warn(
        "repro_torch.core.sim.run() is deprecated; use "
        "repro_torch.sync.run(Spec(...)), which returns a typed Result",
        DeprecationWarning, stacklevel=2)
    return execute(p, energy_fit=energy_fit, device=device)
