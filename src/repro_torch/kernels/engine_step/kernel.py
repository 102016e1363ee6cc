"""The CUDA ``engine_step`` library: build, bind and launch.

The source is ``repro_torch/csrc/engine_step.cu``, built and loaded by
``repro_torch.kernels._build`` (``nvcc`` at first use, cached by content
hash; nothing runs at import time).  It holds two kernels:

* ``fused_step_cuda`` launches ``engine_step_kernel``, one cycle's bank
  side, on PyTorch's current stream (through ``step_launch``) and adds
  one to ``LAUNCHES["engine_step"]`` per launch.  It updates the bank-state
  tensors in place and returns them in the result dict.  The plain loop
  (``core.sim._simulate_plain``) calls it once per cycle on the card.
* ``run_cuda_batch`` launches ``engine_run_kernel`` once for a batch of
  runs of one core count, one thread block per run, and adds one to
  ``LAUNCHES["engine_run"]`` per launch (not per run).  A launch that
  holds a run of the two-level queues or nb_feb (``WIDE_FAMILIES``) runs
  on the kernel's wide instance, the others on the one without their
  branches.  It returns each
  run's ``core.sim.simulate`` result dict, every tensor a view of ONE
  flat device buffer per launch, so a batch comes back to the host in
  one copy.  A launch that holds a workload program of more than one
  step or with a barrier step runs on the program instance, and one
  that holds a run on a hierarchical topology on a topology instance
  (``launch_variant``), and one that holds a run with a fault plan on
  the fault instance.  A skewed Zipf stream travels as its threshold
  table (``core.workloads.base.zipf_thresholds``), one per distinct
  stream in the launch's buffer, and a fault plan's host-drawn victim
  masks as one byte a core (kills, stalls) and a bank (bank stalls).
  ``run_cuda`` is its one-run case.
  ``run_scalars`` is the pure function that derives every per-run scalar
  it passes.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.metrics import LAT_BINS
from repro_torch.core.protocols.base import (KERNEL_AMO, KERNEL_EVENT,
                                             KERNEL_FEB, KERNEL_HIER,
                                             KERNEL_LOCK, KERNEL_LRSC,
                                             KERNEL_QUEUE, KERNEL_TICKET)
from repro_torch.core import topologies as topo_registry
from repro_torch.core.workloads.base import (ADDR_ZIPF, K_BARRIER,
                                             zipf_factors, zipf_thresholds)
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.engine_step.ref import _param_ns
from repro_torch.obs.schema import TELE_K, window_len

#: the package root (``.../repro_torch``) whose ``csrc/`` holds the source
_PKG = _build.PKG


def build_dir() -> Path:
    """Where the library is built (see ``_build.build_dir``)."""
    return _build.build_dir(_PKG)


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.library("engine_step").engine_step_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 16 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_branch(proto, kernel: str, core=None) -> None:
    """Raise ``NotImplementedError`` for a protocol the CUDA kernels have
    no branch for, or one whose per-core fields are not its family's
    (the ticket lock's ``tkt`` is the only per-core field they carry)."""
    if proto.kernel_code not in _BANK_LAYOUT:
        raise NotImplementedError(
            f"the {kernel} CUDA kernel has no branch for protocol "
            f"{proto.name!r}")
    fields = tuple(_CORE_LAYOUT.get(proto.kernel_code, {}))
    if (proto.fused_core_fields != fields or proto.fused_xset_fields
            != fields or (core is not None and tuple(core) != fields)):
        raise NotImplementedError(
            f"protocol {proto.name!r} needs per-core fields "
            f"{proto.fused_core_fields}, which the {kernel} CUDA kernel "
            f"does not take")


#: the two-level queues' bank state (colibri_hier's; hw_event has no
#: turn_srv)
_HIER_LAYOUT = {
    "lqbuf": (torch.int32, -1), "lqhead": (torch.int32, 0),
    "lqlen": (torch.int32, 0), "ggq": (torch.int32, -1),
    "gqhead": (torch.int32, 0), "gqlen": (torch.int32, 0),
    "g_inq": (torch.bool, False), "cur_grp": (torch.int32, -1),
    "turn_srv": (torch.int32, 0), "wake_tmr": (torch.int32, 0),
    "wake_grp": (torch.int32, 0)}
#: bank-state arrays each protocol family carries: (dtype, the value
#: every element starts at, as ``init_bank_state`` gives it)
_BANK_LAYOUT = {
    KERNEL_AMO: {},
    KERNEL_LRSC: {"resv_core": (torch.int32, -1),
                  "resv_valid": (torch.bool, False)},
    KERNEL_QUEUE: {"qbuf": (torch.int32, -1), "qhead": (torch.int32, 0),
                   "qlen": (torch.int32, 0), "wake_tmr": (torch.int32, 0)},
    KERNEL_LOCK: {"lock": (torch.bool, False)},
    KERNEL_TICKET: {"next_tkt": (torch.int32, 0),
                    "serving": (torch.int32, 0)},
    KERNEL_HIER: _HIER_LAYOUT,
    KERNEL_EVENT: {k: v for k, v in _HIER_LAYOUT.items() if k != "turn_srv"},
    KERNEL_FEB: {"feb": (torch.bool, True), "qbuf": (torch.int32, -1),
                 "qhead": (torch.int32, 0), "qlen": (torch.int32, 0),
                 "wake_tmr": (torch.int32, 0)},
}
#: per-core state arrays a family carries (``init_core_state``), which
#: are also its ``fused_core_fields`` and ``fused_xset_fields``
_CORE_LAYOUT = {KERNEL_TICKET: {"tkt": (torch.int32, -1)}}
#: the bank-state pointers ``engine_step_launch`` takes, in the order of
#: the source's ``BankState`` (null where the family has no such array)
STEP_BANK = ("resv_core", "resv_valid", "qbuf", "qhead", "qlen", "wake_tmr",
             "lock", "next_tkt", "serving", "feb", "lqbuf", "lqhead",
             "lqlen", "ggq", "g_inq", "cur_grp", "turn_srv", "gqhead",
             "gqlen", "wake_grp")


def bank_shape(key: str, a: int, q_cap: int, groups: int,
               group_cap: int) -> tuple:
    """The shape of bank-state array ``key`` at ``a`` banks: the FIFO
    queues' ``qbuf`` has ``q_cap`` slots a bank; the two-level queues'
    local queues are ``a * groups`` rows of ``group_cap`` slots and their
    global FIFOs ``(a, groups)``; the rest are ``(a,)``."""
    if key == "qbuf":
        return (a, q_cap)
    if key == "lqbuf":
        return (a * groups, group_cap)
    if key in ("lqhead", "lqlen"):
        return (a * groups,)
    if key in ("ggq", "g_inq"):
        return (a, groups)
    return (a,)


def fused_step_cuda(proto, p, bank: Dict, *, cand_cyc, **kw) -> Dict:
    """Launch the CUDA kernel; same contract as ``ref.fused_step_ref``,
    except that the bank tensors are updated in place."""
    dev = cand_cyc.device
    if dev.type != "cuda":
        raise ValueError(f"fused_step_cuda needs CUDA tensors, got {dev}")
    # the library is built at the call, after step_launch's checks
    out = step_launch(lambda *args: _launcher()(*args), proto, p, bank,
                      cand_cyc=cand_cyc,
                      stream=torch.cuda.current_stream(dev).cuda_stream, **kw)
    LAUNCHES["engine_step"] += 1
    return out


def step_launch(launch, proto, p, bank: Dict, *, cand_cyc, rot, addr,
                phase, acq_start, core: Dict, cyc: int, shift: int, lat: int,
                n: int, a: int, q_cap: int, cycles: int, stream=None) -> Dict:
    """One call of ``engine_step_launch`` (``launch``, the library's entry
    or a build of the same source for another device) on the tensors'
    device: the arguments checked and packed, the outputs allocated.
    ``fused_step_cuda`` is its CUDA case."""
    code = proto.kernel_code
    _require_branch(proto, "engine_step", core)
    dev = cand_cyc.device
    for name, t in (("cand_cyc", cand_cyc), ("rot", rot), ("addr", addr),
                    ("phase", phase), ("acq_start", acq_start)):
        _check(name, t, (n,), torch.int32, dev)
    layout = _BANK_LAYOUT[code]
    if set(bank) != set(layout):
        raise ValueError(f"bank state keys {sorted(bank)} do not match "
                         f"protocol {proto.name!r} ({sorted(layout)})")
    args = proto.kernel_args(_param_ns(p, lat))
    if code in (KERNEL_HIER, KERNEL_EVENT) and n != p.n_cores:
        raise ValueError(f"protocol {proto.name!r} sizes its groups for "
                         f"{p.n_cores} cores, the step has {n}")
    for k, (dt, _) in layout.items():
        _check(k, bank[k], bank_shape(k, a, q_cap, args.groups,
                                      args.group_cap), dt, dev)

    for k in _CORE_LAYOUT.get(code, {}):
        _check(k, core[k], (n,), torch.int32, dev)

    valid = torch.empty((a,), dtype=torch.bool, device=dev)
    win, kind, tmr = (torch.empty((a,), dtype=torch.int32, device=dev)
                      for _ in range(3))
    acc = torch.zeros((3 + LAT_BINS,), dtype=torch.int32, device=dev)
    stats, hist = acc[:3], acc[3:]
    xset = {k: (torch.empty((a,), dtype=torch.int32, device=dev),
                torch.empty((a,), dtype=torch.bool, device=dev))
            for k in _CORE_LAYOUT.get(code, {})}

    def ptr(d, k, j=None):
        if k not in d:
            return None
        return (d[k] if j is None else d[k][j]).data_ptr()

    banks = (ctypes.c_void_p * len(STEP_BANK))(
        *(ptr(bank, k) for k in STEP_BANK))
    err = launch(
        cand_cyc.data_ptr(), rot.data_ptr(), addr.data_ptr(),
        phase.data_ptr(), acq_start.data_ptr(), ctypes.addressof(banks),
        ptr(core, "tkt"), ptr(xset, "tkt", 0), ptr(xset, "tkt", 1),
        valid.data_ptr(), win.data_ptr(), kind.data_ptr(), tmr.data_ptr(),
        stats.data_ptr(), hist.data_ptr(),
        n, a, code, q_cap, args.q_full, cyc, shift, lat, args.acq_tmr,
        args.wake_delay, args.msg_rule, cycles, args.groups,
        args.group_size, args.group_cap, args.local_delay, stream)
    if err != 0:
        raise RuntimeError(f"engine_step kernel launch failed: CUDA error "
                           f"{err}")
    return dict(valid=valid, win=win, kind=kind, tmr=tmr, bank=bank,
                xset=xset, polls=stats[0], msgs=stats[1], hist=hist,
                lat_max=stats[2])


# ---- the whole-run kernel -------------------------------------------------

#: ``engine_run_launch``'s int32 parameters, in the order of the source's
#: ``Param`` enum; those of ``PARAM_SPANS`` span that many words each
RUN_PARAMS = ("n", "a", "n_addrs", "cycles", "proto", "q_cap", "q_full",
              "lat", "acq_tmr", "wake_delay", "msg_rule", "prog_len",
              "n_bar", "zipf_c", "zipf_n_thr", "exp_cap", "seed", "net_bw",
              "hol_block", "n_workers", "n_atomic", "stagger", "trace",
              "tele_windows", "tele_cw", "groups", "group_size",
              "group_cap", "local_delay", "topo_levels", "topo_core_size",
              "topo_core_clusters", "topo_bank_clusters", "bo_tab",
              "pre_dur", "mod_dur", "addr_mode", "fix_addr", "is_bar",
              "bar_prefix", "level_extra", "level_bw", "f_flags", "kill_cyc",
              "n_kill", "n_kill_eff", "stall_cyc", "stall_end", "n_stall_eff",
              "bstall_cyc", "bstall_end", "n_bstall_eff", "drop_bp",
              "drop_salt", "wdrop_salt", "watchdog", "prog_thr")
#: backoff bases passed: streak k reads entry min(k, BO_TAB - 1), and
#: ``backoff << 32`` and beyond is 0 (``shl32``)
BO_TAB = 34
#: steps a workload program may have on the run kernel: its step tables
#: (each step's local work, modify duration, address mode, fixed address,
#: barrier flag and the barrier steps before it) are words of the run
MAX_STEPS = 16
#: boundary levels a hierarchical topology may have on the run kernel:
#: each level's extra latency and link budget are words of the run
MAX_LEVELS = 2
#: cores a run on a hierarchical topology may have on the run kernel: the
#: acceptance pass packs each level's count of crossing requesters into a
#: 16-bit field of one word (the integer-range pass proves this limit
#: sound and tight)
MAX_TOPO_CORES = 1 << 16
PARAM_SPANS = {"bo_tab": BO_TAB, "pre_dur": MAX_STEPS,
               "mod_dur": MAX_STEPS, "addr_mode": MAX_STEPS,
               "fix_addr": MAX_STEPS, "is_bar": MAX_STEPS,
               "bar_prefix": MAX_STEPS, "level_extra": MAX_LEVELS,
               "level_bw": MAX_LEVELS}
#: int32 words a run's parameters take
N_PARAM_WORDS = sum(PARAM_SPANS.get(k, 1) for k in RUN_PARAMS)
#: its device pointers, in the order of the source's ``Ptr`` enum
RUN_PTRS = ("st", "tmr", "addr", "phase", "nxt", "opc", "ops", "arr_cyc",
            "streak", "parked", "acq_start", "w_tmr", "w_served",
            "addr_ops", "lat_hist", "scalars", "resv_core", "resv_valid",
            "qbuf", "qhead", "qlen", "wake_tmr", "lock", "next_tkt",
            "serving", "tkt", "feb", "lqbuf", "lqhead", "lqlen", "ggq",
            "g_inq", "cur_grp", "turn_srv", "gqhead", "gqlen", "wake_grp",
            "tele", "trace_step", "trace_wait", "trace_state", "trace_qlen",
            "scratch", "pc", "bar_cnt", "hops", "zipf_thr", "kmask",
            "dead_mask", "wd_srv", "wd_own", "fault_masks")
#: the run's 0-d outputs, in the order of the source's ``Scalar`` enum
RUN_SCALARS = ("resp_prev", "msgs", "polls", "sleep_cyc", "lat_max",
               "active_cyc", "backoff_cyc", "bank_ops", "net_stall",
               "bar_cyc", "faults_injected", "last_ret", "halt_cyc", "kleft",
               "recoveries")
#: a fault plan's flags (``f_flags``, the source's ``F_*``): any fault
#: machinery, a holder kill, a uniform kill, a stall window, a bank
#: stall, message drops, the watchdog (armed, and the protocol holds
#: banks), the uniform kill's and the stall's victims dead at the horizon
(F_ON, F_HOLDER, F_UNIFORM, F_STALL, F_BSTALL, F_DROP, F_WD, F_DM_KILL,
 F_DM_STALL) = (1 << j for j in range(9))
#: the words of a run without a fault plan
_NO_FAULT = dict.fromkeys(RUN_PARAMS[RUN_PARAMS.index("f_flags"):], 0)

_MASK32 = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1


def shl32(v: int, k: int) -> int:
    """int32 ``v << k`` with the reference's wrap (0 once k >= 32)."""
    if k >= 32:
        return 0
    r = (v << k) & _MASK32
    return r - (1 << 32) if r >= 1 << 31 else r


@functools.lru_cache(maxsize=None)
def _bo_tab(backoff: int, exp_cap: int) -> tuple:
    """Backoff base by failure streak: ``backoff << max(k - 1, 0)``,
    streaks capped at ``exp_cap``."""
    return tuple(shl32(backoff, max(min(k, exp_cap) - 1, 0))
                 for k in range(BO_TAB))


def refuse_on_card(p, proto, prog) -> None:
    """Raise ``NotImplementedError`` for a run of ``SimParams`` ``p`` that
    the ``engine_run`` kernel does not take: a protocol without its
    branch, a program of more than ``MAX_STEPS`` steps, a topology of
    more than ``MAX_LEVELS`` levels, off the default tree or of
    ``MAX_TOPO_CORES`` cores or more.  Cheap: a sweep checks every point
    with it before its first launch."""
    _require_branch(proto, "engine_run")
    if prog.length > MAX_STEPS:
        raise NotImplementedError(
            f"the engine_run kernel runs programs of at most {MAX_STEPS} "
            f"steps, by design: a program's step tables are words of each "
            f"run's parameters (workload {p.workload!r} has {prog.length}; "
            f"the plain loop, device='cpu', runs it)")
    topo = topo_registry.get(p.topology)
    levels, n = len(topo.levels), p.n_cores
    if levels and (levels > MAX_LEVELS or not topo.uses_default_tree()
                   or n >= MAX_TOPO_CORES):
        raise NotImplementedError(
            f"the engine_run kernel runs topologies of at most {MAX_LEVELS} "
            f"levels on the default cluster tree, below {MAX_TOPO_CORES} "
            f"cores (topology {p.topology!r}, {levels} levels, {n} cores)")


def run_scalars(p, proto, prog, banks=None, traced=False) -> Dict[str, Any]:
    """Every per-run scalar ``run_cuda`` passes to the kernel, derived from
    ``SimParams`` ``p``, the protocol and the workload's program as
    ``core.sim._simulate_plain`` derives them: Python ints (the seed
    reduced mod 2^32), ``zipf_c`` a float (the skew-0 Zipf factor, 0.0
    without a Zipf step), ``bo_tab`` a tuple of ``BO_TAB`` ints, the
    step tables (``PARAM_SPANS``) tuples of ``MAX_STEPS`` ints, the
    program's ``prog_len`` steps first and zeros past them, and the
    topology's level words tuples of ``MAX_LEVELS`` ints.  Beside them,
    ``zipf_thr``: a skewed Zipf stream's thresholds (``zipf_n_thr`` of
    them; ``traced`` picks the sweep's form), else None; the fault
    plan's words (``f_flags`` through ``prog_thr``, all 0 without one)
    and ``fault_masks``, its victim masks (:func:`_fault_words`), else
    None.

    ``a`` is the banks allocated, ``banks`` (default ``p.n_addrs``; a
    sweep passes the power-of-two bucket), and ``n_addrs`` the live
    address count the stream hashes over.  The topology's bank clusters
    are placed over ``a``, as the plain loop compiles its tables.  A
    program of more than ``MAX_STEPS`` steps is refused, and so is a
    topology of more than ``MAX_LEVELS`` levels or one off the default
    tree."""
    refuse_on_card(p, proto, prog)
    pt = prog.tables()
    L = prog.length
    n, n_addrs = p.n_cores, p.n_addrs
    a = n_addrs if banks is None else banks
    if a < n_addrs:
        raise ValueError(f"banks={a} is below n_addrs={n_addrs}")
    exp_cap = 1 if proto.fixed_backoff else p.backoff_exp
    args = proto.kernel_args(p)
    is_bar = [int(k == K_BARRIER) for k in prog.kind]

    def steps(vals):
        return tuple(int(v) for v in vals) + (0,) * (MAX_STEPS - L)

    zipf_c, zipf_thr = 0.0, None
    if ADDR_ZIPF in prog.addr_mode:
        c = zipf_factors(n_addrs, p.zipf_skew)
        if c is None:
            zipf_thr = zipf_thresholds(n_addrs, p.zipf_skew, traced)
        else:
            zipf_c = c
    topo = topo_registry.get(p.topology)
    levels = len(topo.levels)
    core_size, core_clusters, bank_clusters = topo.leaf_geometry(p, n, a)
    faults, fault_masks = _fault_words(p, proto, n, a)
    return dict(
        **faults, fault_masks=fault_masks,
        n=n, a=a, n_addrs=n_addrs, cycles=p.cycles,
        proto=proto.kernel_code,
        q_cap=proto.q_cap(p, n), q_full=args.q_full, lat=p.lat,
        acq_tmr=args.acq_tmr, wake_delay=args.wake_delay,
        msg_rule=args.msg_rule,
        prog_len=L, n_bar=sum(is_bar), zipf_c=zipf_c,
        zipf_n_thr=0 if zipf_thr is None else len(zipf_thr),
        zipf_thr=zipf_thr, exp_cap=exp_cap,
        seed=int(p.seed) & _MASK32,
        net_bw=p.net_bw, hol_block=p.hol_block, n_workers=p.n_workers,
        n_atomic=n - min(p.n_workers, n), stagger=p.work + 1,
        trace=int(bool(p.record_trace)),
        tele_windows=p.telemetry_windows,
        tele_cw=(window_len(p.cycles, p.telemetry_windows)
                 if p.telemetry_windows else 0),
        groups=args.groups, group_size=args.group_size,
        group_cap=args.group_cap, local_delay=args.local_delay,
        topo_levels=levels, topo_core_size=core_size,
        topo_core_clusters=core_clusters, topo_bank_clusters=bank_clusters,
        level_extra=_levels(lv.extra_lat for lv in topo.levels),
        level_bw=_levels(max(p.net_bw // lv.bw_div, 1)
                         for lv in topo.levels),
        bo_tab=_bo_tab(p.backoff, exp_cap),
        pre_dur=steps(int(m) * p.work + int(x)
                      for m, x in zip(pt["pre_mult"], pt["pre_add"])),
        mod_dur=steps(int(m) * p.modify + int(x)
                      for m, x in zip(pt["mod_mult"], pt["mod_add"])),
        addr_mode=steps(pt["addr_mode"]),
        fix_addr=steps((int(x) & _MASK32) % n_addrs
                       for x in pt["addr_arg"]),
        is_bar=steps(is_bar),
        bar_prefix=steps(np.cumsum([0] + is_bar[:-1])))


def _fault_words(p, proto, n: int, a: int):
    """A run's fault words (``_NO_FAULT``'s keys) and its victim masks,
    one uint8 a core for the uniform kill and for the stall, then one a
    bank for the bank stall, drawn over the ``a`` banks allocated (None
    without a plan).  The drop streams' salts are the reference's
    ``fault_seed * 977 + 13`` and ``fault_seed * 389 + 7`` mod 2^32."""
    fp = p.faults
    if not fp.enabled:
        return _NO_FAULT, None
    # the watchdog runs where the protocol holds banks (amo holds none)
    holds = proto.held(proto.init_bank_state(p, 1, n, 1, "cpu")) is not None
    holder = fp.n_kill > 0 and fp.kill_holder == 1
    uniform = fp.n_kill > 0 and fp.kill_holder == 0
    stall, bstall = fp.n_stall > 0, fp.n_bank_stall > 0
    flags = (F_ON | F_HOLDER * holder | F_UNIFORM * uniform
             | F_STALL * stall | F_BSTALL * bstall
             | F_DROP * (fp.msg_drop_bp > 0)
             | F_WD * (fp.watchdog_cyc > 0 and holds)
             | F_DM_KILL * (uniform and fp.kill_cyc < p.cycles)
             | F_DM_STALL * (stall and fp.stall_cyc <= p.cycles - 1
                             < fp.stall_cyc + fp.stall_dur))

    def clip(v):
        return min(int(v), _INT32_MAX)

    none = np.zeros(n, dtype=bool)
    masks = np.concatenate([
        fp.kill_mask(n) if uniform else none,
        fp.stall_mask(n) if stall else none,
        fp.bank_stall_mask(a) if bstall else np.zeros(a, dtype=bool),
    ]).astype(np.uint8)
    return dict(
        f_flags=flags, kill_cyc=clip(fp.kill_cyc), n_kill=clip(fp.n_kill),
        n_kill_eff=min(fp.n_kill, n), stall_cyc=clip(fp.stall_cyc),
        stall_end=clip(fp.stall_cyc + fp.stall_dur),
        n_stall_eff=min(fp.n_stall, n),
        bstall_cyc=clip(fp.bank_stall_cyc),
        bstall_end=clip(fp.bank_stall_cyc + fp.bank_stall_dur),
        n_bstall_eff=min(fp.n_bank_stall, a), drop_bp=fp.msg_drop_bp,
        drop_salt=(fp.fault_seed * 977 + 13) & _MASK32,
        wdrop_salt=(fp.fault_seed * 389 + 7) & _MASK32,
        watchdog=clip(fp.watchdog_cyc),
        prog_thr=clip(fp.progress_threshold())), masks


def _levels(vals) -> tuple:
    """A topology's per-level words: its levels first, zeros past them."""
    vals = tuple(int(v) for v in vals)
    return vals + (0,) * (MAX_LEVELS - len(vals))


def _pack_params(sc: Dict[str, Any]) -> list:
    """``run_scalars``' values as the kernel's int32 words (the float's
    bits, the uint32 seed's two's complement)."""
    words = []
    for k in RUN_PARAMS:
        v = sc[k]
        if k in PARAM_SPANS:
            words += list(v)
        elif k == "zipf_c":
            words.append(int(np.float32(v).view(np.int32)))
        elif k in ("seed", "drop_salt", "wdrop_salt"):       # uint32 bits
            words.append(v - (1 << 32) if v >= 1 << 31 else v)
        else:
            words.append(int(v))
    return words


@functools.lru_cache(maxsize=1)
def _run_library():
    lib = _build.library("engine_step")
    lib.engine_run_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.engine_run_launch.restype = ctypes.c_int
    for fn in (lib.engine_run_scratch_bytes, lib.engine_run_smem_bytes):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_longlong
    return lib


#: marks a 0-d output of ``result_arrays``: a view of the run's
#: ``RUN_SCALARS`` buffer
SCALAR = "scalar"


def result_arrays(p, proto, sc: Dict[str, Any]) -> Dict[str, Any]:
    """The run's result arrays in ``simulate``'s key order, each as
    ``(dtype, shape, init)``: ``init`` is None for what the kernel
    writes, else the value every element starts at (0, or the protocol's
    initial bank state); the 0-d outputs of ``RUN_SCALARS`` are
    ``SCALAR``.  The bank state's values are ``_BANK_LAYOUT``'s, held
    against the protocol's own ``init_bank_state`` at one bank and one
    queue slot (not built at full size on the host)."""
    _check_bank_layout(proto, p, sc["n"])
    return dict(_layout(*_layout_key(sc)))


#: protocols whose initial bank state is held to ``_BANK_LAYOUT``
_LAYOUT_CHECKED = set()


def _check_bank_layout(proto, p, n: int) -> None:
    """Raise unless ``proto``'s initial bank state has ``_BANK_LAYOUT``'s
    keys, dtypes and values and its per-core state ``_CORE_LAYOUT``'s
    (once per protocol)."""
    if proto.name in _LAYOUT_CHECKED:
        return
    for what, probe, layout in (
            ("bank", proto.init_bank_state(p, 1, n, 1, "cpu"),
             _BANK_LAYOUT[proto.kernel_code]),
            ("per-core", proto.init_core_state(p, 1, "cpu"),
             _CORE_LAYOUT.get(proto.kernel_code, {}))):
        if set(probe) != set(layout):
            raise ValueError(f"{what} state keys {sorted(probe)} do not "
                             f"match protocol {proto.name!r} "
                             f"({sorted(layout)})")
        for k, (dt, value) in layout.items():
            if probe[k].dtype != dt or not bool((probe[k] == value).all()):
                raise ValueError(f"protocol {proto.name!r} starts {k} at "
                                 f"{probe[k].tolist()}, the kernel at "
                                 f"{value}")
    _LAYOUT_CHECKED.add(proto.name)


def _layout_key(sc: Dict[str, Any]) -> tuple:
    """The arguments of :func:`_layout` from a run's scalars."""
    return (sc["proto"], sc["n"], sc["a"], sc["q_cap"], sc["groups"],
            sc["group_cap"], sc["cycles"], sc["tele_windows"], sc["trace"],
            int(sc["topo_levels"] > 0),
            sc["f_flags"] & (F_ON | F_HOLDER | F_WD))


@functools.lru_cache(maxsize=4096)
def _layout(code: int, n: int, a: int, q_cap: int, groups: int,
            group_cap: int, cycles: int, tele_windows: int,
            trace: int, topo: int = 0, faults: int = 0) -> tuple:
    """``result_arrays``' items for a run of this shape (hashable: a
    launch groups its runs by it); ``faults`` holds the ``F_ON``,
    ``F_HOLDER`` and ``F_WD`` flags of its plan."""
    i32 = torch.int32

    def w(shape, dtype=i32):
        return (dtype, shape, None)

    def z(shape=()):
        return (i32, shape, 0)

    out = dict(st=w((n,)), tmr=w((n,)), addr=w((n,)), phase=w((n,)),
               nxt=w((n,)), pc=w((n,)), bar_cnt=w((n,)), opc=w((n,)),
               arr_cyc=w((n,)), streak=w((n,)),
               parked=w((n,), torch.bool), resp_prev=SCALAR, ops=w((n,)),
               acq_start=w((n,)), msgs=SCALAR, polls=SCALAR,
               addr_ops=w((a,)), sleep_cyc=SCALAR, bar_cyc=SCALAR,
               lat_hist=w((LAT_BINS,)), lat_max=SCALAR,
               active_cyc=SCALAR, backoff_cyc=SCALAR, bank_ops=SCALAR,
               net_stall=SCALAR, w_tmr=w((n,)), w_served=w((n,)))
    if topo:
        out["hops"] = w(())
    if tele_windows:
        out["tele"] = z((tele_windows, TELE_K))
    for k, (dt, value) in _BANK_LAYOUT[code].items():
        out[k] = (dt, bank_shape(k, a, q_cap, groups, group_cap), value)
    for k, (dt, _) in _CORE_LAYOUT.get(code, {}).items():
        out[k] = w((n,), dt)                 # the kernel writes its start
    if faults:
        out.update(faults_injected=SCALAR, last_ret=SCALAR,
                   halt_cyc=SCALAR)
        if faults & F_HOLDER:
            out.update(kmask=w((n,), torch.bool), kleft=SCALAR)
        if faults & F_WD:                    # updated in place
            out.update(wd_srv=z((a,)), wd_own=(i32, (a,), n))
        out.update(recoveries=SCALAR, dead_mask=w((n,), torch.bool))
    if trace:
        out.update(trace_step=w((cycles, n)), trace_wait=w((cycles, n)),
                   trace_state=w((cycles, n), torch.int8),
                   trace_qlen=w((cycles, a)))
    return tuple(out.items())


def _nbytes(dtype, shape) -> int:
    return math.prod(shape) * dtype.itemsize


@functools.lru_cache(maxsize=None)
def _strides(shape) -> tuple:
    """Contiguous strides of ``shape``, in elements."""
    out, step = [], 1
    for d in reversed(shape):
        out.append(step)
        step *= d
    return tuple(reversed(out))


@functools.lru_cache(maxsize=None)
def _fill_byte(dtype, value):
    """The byte every byte of an array of ``value`` holds (0 for zeros and
    False, 255 for -1), or None when they differ."""
    raw = torch.tensor(value, dtype=dtype).numpy().reshape(-1).view(np.uint8)
    return int(raw[0]) if (raw == raw[0]).all() else None


def pack_runs(runs: Sequence[Tuple[Any, Any, Dict[str, Any]]], dev,
              scratch_bytes=None, started=None) -> Dict[str, Any]:
    """Lay out a launch of ``runs`` (``(p, proto, run_scalars)`` each) in
    ONE flat uint8 buffer on ``dev``: the runs' parameter words and
    pointer tables (``RUN_PTRS``), the skewed Zipf streams' threshold
    tables (one copy of each distinct table), then their result arrays
    (first those
    with an initial value, grouped by it, then those the kernel writes),
    then each run's scratch (``scratch_bytes(n, a)`` bytes, 0 without).
    Runs with the same ``result_arrays`` layout form a group, and each of
    a group's arrays is one region holding its runs' arrays back to back
    (16-byte aligned), so one call makes the views of all of them.  The
    words and pointers (and any initial value that is not one repeated
    byte) are filled on the host and copied in one copy (from pinned
    memory on a GPU); the arrays of one repeated byte (zeros, -1, False)
    are set by one fill per byte value.  ``started``, a CUDA event, is
    recorded on the stream before the first of these copies (after the
    host's work).  Returns ``flat``, the device addresses ``params`` and
    ``ptrs``, and ``outs``: each run's result dict of views, with its
    scalars buffer under ``"scalars"``."""
    dev = torch.device(dev)
    size = 0

    def take(nbytes: int) -> int:
        nonlocal size
        at = size
        size = (size + nbytes + 15) & ~15
        return at

    words = np.array([_pack_params(sc) for _, _, sc in runs],
                     dtype=np.int32)
    w_at = take(words.nbytes)
    p_at = take(8 * len(RUN_PTRS) * len(runs))
    tables: Dict[int, tuple] = {}            # id(table) -> (table, at)
    for _, _, sc in runs:
        thr = sc.get("zipf_thr")
        if thr is not None and id(thr) not in tables:
            tables[id(thr)] = (thr, take(thr.nbytes))
    masks = {b: take(sc["fault_masks"].nbytes)   # run -> at
             for b, (_, _, sc) in enumerate(runs)
             if sc.get("fault_masks") is not None}
    groups: Dict[tuple, list] = {}           # layout -> [run indices]
    for b, (p, proto, sc) in enumerate(runs):
        _check_bank_layout(proto, p, sc["n"])
        groups.setdefault(_layout(*_layout_key(sc)), []).append(b)
    # regions: (group, key, dtype, shape, stride) -> offset
    fills: Dict[int, list] = {}
    staged, written = [], []
    for sig, idxs in groups.items():
        written.append((sig, "scalars", torch.int32, (len(RUN_SCALARS),)))
        for k, v in sig:
            if v is SCALAR:
                continue
            dtype, shape, init = v
            if init is None:
                written.append((sig, k, dtype, shape))
                continue
            fill = _fill_byte(dtype, init)
            (staged if fill is None else fills.setdefault(fill, [])).append(
                (sig, k, dtype, shape))
    at = {}

    def place(region):
        sig, k, dtype, shape = region
        stride = (_nbytes(dtype, shape) + 15) & ~15
        at[(sig, k)] = (take(stride * len(groups[sig])), stride)

    for region in staged:
        place(region)
    host_end = size                          # words, pointers, staged
    spans = {}
    for fill, regions in fills.items():      # one contiguous span a byte
        lo = size
        for region in regions:
            place(region)
        spans[fill] = (lo, size)
    for region in written:
        place(region)
    scratch = {}
    for b, (_, _, sc) in enumerate(runs):
        n_scratch = scratch_bytes(sc["n"], sc["a"]) if scratch_bytes else 0
        if n_scratch:
            scratch[b] = take(n_scratch)
    flat = torch.empty(size, dtype=torch.uint8, device=dev)
    host = torch.empty(host_end, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    hn = host.numpy()
    base = flat.data_ptr()
    hn[w_at:w_at + words.nbytes] = words.reshape(-1).view(np.uint8)
    for thr, off in tables.values():
        hn[off:off + thr.nbytes] = np.ascontiguousarray(
            thr, dtype=np.int32).view(np.uint8)
    for b, off in masks.items():
        fm = runs[b][2]["fault_masks"]
        hn[off:off + fm.nbytes] = fm
    typed = {}                     # flat as each dtype, for the views
    outs: List[Dict[str, Any]] = [None] * len(runs)  # type: ignore
    ptrs = np.zeros((len(runs), len(RUN_PTRS)), dtype=np.int64)
    col = {k: j for j, k in enumerate(RUN_PTRS)}
    for sig, idxs in groups.items():
        g = len(idxs)
        views = {}
        for k, dtype, shape in [("scalars", torch.int32,
                                 (len(RUN_SCALARS),))] + [
                (k, v[0], v[1]) for k, v in sig if v is not SCALAR]:
            off, stride = at[(sig, k)]
            if dtype not in typed:
                typed[dtype] = flat.view(dtype)
            size_t = dtype.itemsize
            views[k] = typed[dtype].as_strided(
                (g,) + shape, (stride // size_t,) + _strides(shape),
                off // size_t).unbind(0)
            if k in col:
                ptrs[idxs, col[k]] = base + off + stride * np.arange(g)
            if off < host_end:                           # staged
                raw = torch.full(shape, dict(sig)[k][2], dtype=dtype
                                 ).numpy().reshape(-1).view(np.uint8)
                for i in range(g):
                    hn[off + i * stride:off + i * stride + raw.size] = raw
        # each scalar output of each run: a 0-d view of its scalars row
        rows = typed[torch.int32].as_strided(
            (g, len(RUN_SCALARS)), (at[(sig, "scalars")][1] // 4, 1),
            at[(sig, "scalars")][0] // 4)
        zero_d = {k: c.unbind(0) for k, c in zip(RUN_SCALARS, rows.unbind(1))}
        for i, b in enumerate(idxs):
            outs[b] = dict({k: zero_d[k][i] if v is SCALAR else views[k][i]
                            for k, v in sig}, scalars=views["scalars"][i])
    for b, off in scratch.items():
        ptrs[b, col["scratch"]] = base + off
    for b, (_, _, sc) in enumerate(runs):
        thr = sc.get("zipf_thr")
        if thr is not None:
            ptrs[b, col["zipf_thr"]] = base + tables[id(thr)][1]
        if b in masks:
            ptrs[b, col["fault_masks"]] = base + masks[b]
    hn[p_at:p_at + ptrs.nbytes] = ptrs.reshape(-1).view(np.uint8)
    if started is not None:
        started.record()
    flat[:host_end].copy_(host, non_blocking=True)
    for fill, (lo, hi) in spans.items():
        flat[lo:hi].fill_(fill)
    return dict(flat=flat, params=base + w_at, ptrs=base + p_at, outs=outs)


def launch_smem(lib, scalars: Sequence[Dict[str, Any]]) -> int:
    """Dynamic shared memory of one launch of runs with these
    ``run_scalars``: the largest ``engine_run_smem_bytes`` of its runs
    (the per-bank layout is the same for every protocol family)."""
    return max(lib.engine_run_smem_bytes(sc["n"], sc["a"]) for sc in scalars)


#: the families only the run kernel's wide instances have a branch for
WIDE_FAMILIES = (KERNEL_HIER, KERNEL_EVENT, KERNEL_FEB)
#: the run kernel's instances (the source's ``run_kernel_for``): without
#: the WIDE_FAMILIES' branches, with them, with them and the program
#: code (the program counter, per-step tables and barrier release), with
#: all of that and the topology stages (extra latency at issue, the
#: levels' link budgets, the hop count), and with all of that and the
#: fault stages (dead cores, drops, bank stalls, the holder kill, the
#: reservation watchdog, the progress detector)
INSTANCE_NARROW, INSTANCE_WIDE, INSTANCE_PROG, INSTANCE_TOPO, \
    INSTANCE_FAULT = range(5)


def launch_variant(scalars: Sequence[Dict[str, Any]]) -> int:
    """The run kernel's instance for a launch of runs with these
    ``run_scalars``: INSTANCE_FAULT when a run has a fault plan, else
    INSTANCE_TOPO when a run is on a hierarchical
    topology, else INSTANCE_PROG when a run's program has more than one
    step or a barrier step, else INSTANCE_WIDE when a run is of the
    two-level queues or nb_feb, else INSTANCE_NARROW (the other families,
    one-step programs on the flat topology: the instance without their
    code)."""
    if any(sc["f_flags"] for sc in scalars):
        return INSTANCE_FAULT
    if any(sc["topo_levels"] > 0 for sc in scalars):
        return INSTANCE_TOPO
    if any(sc["prog_len"] > 1 or sc["n_bar"] > 0 for sc in scalars):
        return INSTANCE_PROG
    if any(sc["proto"] in WIDE_FAMILIES for sc in scalars):
        return INSTANCE_WIDE
    return INSTANCE_NARROW


def run_cuda_batch(runs: Sequence[Tuple[Any, Any, Any, int]], device,
                   started=None, traced=False
                   ) -> List[Dict[str, torch.Tensor]]:
    """Runs of one core count in ONE launch of ``engine_run_kernel`` on
    the CUDA ``device``, one thread block each: ``runs`` holds
    ``(p, proto, prog, banks)`` per run, ``banks`` the banks allocated
    (``p.n_addrs``, or a sweep's bucket above it).  Returns each run's
    ``core.sim.simulate`` result dict, bit for bit, with its bank arrays
    at ``banks`` rows; every tensor is a view of the launch's one flat
    buffer.  ``started``, a CUDA event, is recorded on the stream when
    the host has packed the launch, before its copies and the kernel.
    ``traced`` picks the sweep's form of a skewed Zipf stream (see
    ``core.workloads.base.zipf_index``)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"run_cuda needs a CUDA device, got {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not runs:
        raise ValueError("run_cuda_batch needs at least one run")
    n = runs[0][0].n_cores
    scalars = []
    for p, proto, prog, banks in runs:
        if p.n_cores != n:
            raise ValueError(f"one launch runs one core count: {n} and "
                             f"{p.n_cores}")
        scalars.append((p, proto, run_scalars(p, proto, prog, banks,
                                              traced)))
    lib = _run_library()
    packed = pack_runs(scalars, dev, lib.engine_run_scratch_bytes, started)
    scs = [sc for _, _, sc in scalars]
    err = lib.engine_run_launch(
        len(runs), n, packed["params"], N_PARAM_WORDS,
        packed["ptrs"], len(RUN_PTRS), launch_smem(lib, scs),
        launch_variant(scs), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "engine_run kernel launch failed: "
            + ("the library's parameter layout differs from kernel.py's"
               if err < 0 else f"CUDA error {err}"))
    LAUNCHES["engine_run"] += 1
    outs = packed["outs"]
    for out in outs:
        del out["scalars"]
    return outs


def run_cuda(p, proto, prog, device) -> Dict[str, torch.Tensor]:
    """One engine run of ``SimParams`` ``p`` in one launch of
    ``engine_run_kernel`` on the CUDA ``device``: the result dict of
    ``core.sim.simulate``, bit for bit, as tensors on the card."""
    return run_cuda_batch([(p, proto, prog, p.n_addrs)], device)[0]
