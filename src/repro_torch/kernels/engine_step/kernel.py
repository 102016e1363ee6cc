"""The CUDA ``engine_step`` library: build, bind and launch.

The source is ``repro_torch/csrc/engine_step.cu``, built and loaded by
``repro_torch.kernels._build`` (``nvcc`` at first use, cached by content
hash; nothing runs at import time).  It holds two kernels:

* ``fused_step_cuda`` launches ``engine_step_kernel``, one cycle's bank
  side, on PyTorch's current stream and adds one to
  ``LAUNCHES["engine_step"]`` per launch.  It updates the bank-state
  tensors in place and returns them in the result dict.  The plain loop
  (``core.sim._simulate_plain``) calls it once per cycle on the card.
* ``run_cuda`` launches ``engine_run_kernel``, a whole run of the
  engine in one launch, and adds one to ``LAUNCHES["engine_run"]``.  It
  returns ``core.sim.simulate``'s result dict.  ``run_scalars`` is the
  pure function that derives every per-run scalar it passes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.metrics import LAT_BINS
from repro_torch.core.protocols.base import (KERNEL_AMO, KERNEL_LRSC,
                                             KERNEL_QUEUE)
from repro_torch.core.workloads.base import ADDR_ZIPF, zipf_factors
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.obs.schema import TELE_K, window_len

#: the package root (``.../repro_torch``) whose ``csrc/`` holds the source
_PKG = _build.PKG


def build_dir() -> Path:
    """Where the library is built (see ``_build.build_dir``)."""
    return _build.build_dir(_PKG)


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.library("engine_step").engine_step_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 \
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
    no branch for, or one that needs per-core fields."""
    if proto.kernel_code not in _BANK_LAYOUT:
        raise NotImplementedError(
            f"the {kernel} CUDA kernel has no branch for protocol "
            f"{proto.name!r}")
    if proto.fused_core_fields or proto.fused_xset_fields or core:
        raise NotImplementedError(
            f"protocol {proto.name!r} needs per-core fields, which the "
            f"{kernel} CUDA kernel does not take yet")


#: bank-state arrays each protocol family carries, with their dtypes
_BANK_LAYOUT = {
    KERNEL_AMO: {},
    KERNEL_LRSC: {"resv_core": torch.int32, "resv_valid": torch.bool},
    KERNEL_QUEUE: {"qbuf": torch.int32, "qhead": torch.int32,
                   "qlen": torch.int32, "wake_tmr": torch.int32},
}


def fused_step_cuda(proto, p, bank: Dict, *, cand_cyc, rot, addr, phase,
                    acq_start, core: Dict, cyc: int, shift: int, lat: int,
                    n: int, a: int, q_cap: int, cycles: int) -> Dict:
    """Launch the CUDA kernel; same contract as ``ref.fused_step_ref``,
    except that the bank tensors are updated in place."""
    code = proto.kernel_code
    _require_branch(proto, "engine_step", core)
    dev = cand_cyc.device
    if dev.type != "cuda":
        raise ValueError(f"fused_step_cuda needs CUDA tensors, got {dev}")
    for name, t in (("cand_cyc", cand_cyc), ("rot", rot), ("addr", addr),
                    ("phase", phase), ("acq_start", acq_start)):
        _check(name, t, (n,), torch.int32, dev)
    layout = _BANK_LAYOUT[code]
    if set(bank) != set(layout):
        raise ValueError(f"bank state keys {sorted(bank)} do not match "
                         f"protocol {proto.name!r} ({sorted(layout)})")
    for k, dt in layout.items():
        shape = (a, q_cap) if k == "qbuf" else (a,)
        _check(k, bank[k], shape, dt, dev)

    valid = torch.empty((a,), dtype=torch.bool, device=dev)
    win, kind, tmr = (torch.empty((a,), dtype=torch.int32, device=dev)
                      for _ in range(3))
    acc = torch.zeros((3 + LAT_BINS,), dtype=torch.int32, device=dev)
    stats, hist = acc[:3], acc[3:]
    wake_delay, succ = proto.kernel_args(p)

    def ptr(k):
        return bank[k].data_ptr() if k in bank else None

    err = _launcher()(
        cand_cyc.data_ptr(), rot.data_ptr(), addr.data_ptr(),
        phase.data_ptr(), acq_start.data_ptr(),
        ptr("resv_core"), ptr("resv_valid"), ptr("qbuf"), ptr("qhead"),
        ptr("qlen"), ptr("wake_tmr"),
        valid.data_ptr(), win.data_ptr(), kind.data_ptr(), tmr.data_ptr(),
        stats.data_ptr(), hist.data_ptr(),
        n, a, code, q_cap, cyc, shift, lat, wake_delay, succ, cycles,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"engine_step kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["engine_step"] += 1
    return dict(valid=valid, win=win, kind=kind, tmr=tmr, bank=bank,
                xset={}, polls=stats[0], msgs=stats[1], hist=hist,
                lat_max=stats[2])


# ---- the whole-run kernel -------------------------------------------------

#: ``engine_run_launch``'s int32 parameters, in the order of the source's
#: ``Param`` enum; ``bo_tab`` is the last and spans ``BO_TAB`` entries
RUN_PARAMS = ("n", "a", "cycles", "proto", "q_cap", "lat", "wake_delay",
              "succ", "pre_dur", "mod_dur", "addr_mode", "fix_addr",
              "zipf_c", "exp_cap", "seed", "net_bw", "hol_block",
              "n_workers", "n_atomic", "stagger", "trace", "tele_windows",
              "tele_cw", "bo_tab")
#: backoff bases passed: streak k reads entry min(k, BO_TAB - 1), and
#: ``backoff << 32`` and beyond is 0 (``shl32``)
BO_TAB = 34
#: its device pointers, in the order of the source's ``Ptr`` enum
RUN_PTRS = ("st", "tmr", "addr", "phase", "nxt", "opc", "ops", "arr_cyc",
            "streak", "parked", "acq_start", "w_tmr", "w_served",
            "addr_ops", "lat_hist", "scalars", "resv_core", "resv_valid",
            "qbuf", "qhead", "qlen", "wake_tmr", "tele", "trace_step",
            "trace_wait", "trace_state", "trace_qlen", "scratch")
#: the run's 0-d outputs, in the order of the source's ``Scalar`` enum
RUN_SCALARS = ("resp_prev", "msgs", "polls", "sleep_cyc", "lat_max",
               "active_cyc", "backoff_cyc", "bank_ops", "net_stall")

_MASK32 = 0xFFFFFFFF


def shl32(v: int, k: int) -> int:
    """int32 ``v << k`` with the reference's wrap (0 once k >= 32)."""
    if k >= 32:
        return 0
    r = (v << k) & _MASK32
    return r - (1 << 32) if r >= 1 << 31 else r


def run_scalars(p, proto, prog) -> Dict[str, Any]:
    """Every per-run scalar ``run_cuda`` passes to the kernel, derived from
    ``SimParams`` ``p``, the protocol and the workload's one-step program
    as ``core.sim._simulate_plain`` derives them: Python ints (the seed
    reduced mod 2^32), ``zipf_c`` a float (the skew-0 Zipf factor, 0.0
    for other streams) and ``bo_tab`` a tuple of ``BO_TAB`` ints."""
    pt = prog.tables()
    n, a = p.n_cores, p.n_addrs
    exp_cap = 1 if proto.fixed_backoff else p.backoff_exp
    wake_delay, succ = proto.kernel_args(p)
    addr_mode = int(pt["addr_mode"][0])
    zipf_c = 0.0
    if addr_mode == ADDR_ZIPF:
        _, c, inv = zipf_factors(a, p.zipf_skew)
        if c is None or inv != 1.0:
            raise NotImplementedError(
                f"the engine_run kernel computes the zipf stream at skew 0 "
                f"only (got zipf_skew={p.zipf_skew})")
        zipf_c = c
    bo_tab = tuple(shl32(p.backoff, max(min(k, exp_cap) - 1, 0))
                   for k in range(BO_TAB))
    return dict(
        n=n, a=a, cycles=p.cycles, proto=proto.kernel_code,
        q_cap=proto.q_cap(p, n), lat=p.lat, wake_delay=wake_delay,
        succ=succ,
        pre_dur=int(pt["pre_mult"][0]) * p.work + int(pt["pre_add"][0]),
        mod_dur=int(pt["mod_mult"][0]) * p.modify + int(pt["mod_add"][0]),
        addr_mode=addr_mode,
        fix_addr=(int(pt["addr_arg"][0]) & _MASK32) % a,
        zipf_c=zipf_c, exp_cap=exp_cap, seed=int(p.seed) & _MASK32,
        net_bw=p.net_bw, hol_block=p.hol_block, n_workers=p.n_workers,
        n_atomic=n - min(p.n_workers, n), stagger=p.work + 1,
        trace=int(bool(p.record_trace)),
        tele_windows=p.telemetry_windows,
        tele_cw=(window_len(p.cycles, p.telemetry_windows)
                 if p.telemetry_windows else 0),
        bo_tab=bo_tab)


def _pack_params(sc: Dict[str, Any]) -> list:
    """``run_scalars``' values as the kernel's int32 words (the float's
    bits, the uint32 seed's two's complement)."""
    words = []
    for k in RUN_PARAMS:
        v = sc[k]
        if k == "bo_tab":
            words += list(v)
        elif k == "zipf_c":
            words.append(int(np.float32(v).view(np.int32)))
        elif k == "seed":
            words.append(v - (1 << 32) if v >= 1 << 31 else v)
        else:
            words.append(int(v))
    return words


@functools.lru_cache(maxsize=1)
def _run_library():
    lib = _build.library("engine_step")
    lib.engine_run_launch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p]
    lib.engine_run_launch.restype = ctypes.c_int
    lib.engine_run_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.engine_run_scratch_bytes.restype = ctypes.c_longlong
    return lib


def run_outputs(p, proto, sc: Dict[str, Any], dev) -> Dict[str, Any]:
    """The run's result tensors on ``dev``, in ``simulate``'s key order
    (the bank state initialised, the rest to be written by the kernel),
    and the run scalars' buffer under ``"scalars"``."""
    n, a, cycles = sc["n"], sc["a"], sc["cycles"]
    i32 = torch.int32

    def e(shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=dev)

    def z(shape=()):
        return torch.zeros(shape, dtype=i32, device=dev)

    scal = e(len(RUN_SCALARS))
    s = dict(zip(RUN_SCALARS, scal.unbind()))
    out = dict(st=e(n), tmr=e(n), addr=e(n), phase=e(n), nxt=e(n),
               pc=z(n), bar_cnt=z(n), opc=e(n), arr_cyc=e(n), streak=e(n),
               parked=e(n, torch.bool), resp_prev=s["resp_prev"], ops=e(n),
               acq_start=e(n), msgs=s["msgs"], polls=s["polls"],
               addr_ops=e(a), sleep_cyc=s["sleep_cyc"], bar_cyc=z(),
               lat_hist=e(LAT_BINS), lat_max=s["lat_max"],
               active_cyc=s["active_cyc"], backoff_cyc=s["backoff_cyc"],
               bank_ops=s["bank_ops"], net_stall=s["net_stall"],
               w_tmr=e(n), w_served=e(n))
    if sc["tele_windows"]:
        out["tele"] = z((sc["tele_windows"], TELE_K))
    bank = proto.init_bank_state(p, a, n, sc["q_cap"], dev)
    layout = _BANK_LAYOUT[sc["proto"]]
    if set(bank) != set(layout):
        raise ValueError(f"bank state keys {sorted(bank)} do not match "
                         f"protocol {proto.name!r} ({sorted(layout)})")
    for k, dt in layout.items():
        shape = (a, sc["q_cap"]) if k == "qbuf" else (a,)
        _check(k, bank[k], shape, dt, dev)
    out.update(bank)
    xc = proto.init_core_state(p, n, dev)
    if xc:
        raise NotImplementedError(
            f"protocol {proto.name!r} has per-core state, which the "
            f"engine_run kernel does not carry yet")
    if sc["trace"]:
        out.update(trace_step=e((cycles, n)), trace_wait=e((cycles, n)),
                   trace_state=e((cycles, n), torch.int8),
                   trace_qlen=e((cycles, a)))
    return dict(out, scalars=scal)


def run_cuda(p, proto, prog, device) -> Dict[str, torch.Tensor]:
    """One engine run of ``SimParams`` ``p`` in one launch of
    ``engine_run_kernel`` on the CUDA ``device``: the result dict of
    ``core.sim.simulate``, bit for bit, as tensors on the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"run_cuda needs a CUDA device, got {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _require_branch(proto, "engine_run")
    sc = run_scalars(p, proto, prog)
    out = run_outputs(p, proto, sc, dev)
    lib = _run_library()
    n_scratch = lib.engine_run_scratch_bytes(sc["n"], sc["a"])
    scratch = (torch.empty(n_scratch, dtype=torch.uint8, device=dev)
               if n_scratch else None)
    tensors = dict(out, scratch=scratch)
    ptrs = [tensors[k].data_ptr() if tensors.get(k) is not None else None
            for k in RUN_PTRS]
    words = _pack_params(sc)
    err = lib.engine_run_launch(
        (ctypes.c_int32 * len(words))(*words), len(words),
        (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "engine_run kernel launch failed: "
            + ("the library's parameter layout differs from kernel.py's"
               if err < 0 else f"CUDA error {err}"))
    LAUNCHES["engine_run"] += 1
    del out["scalars"]
    return out
