"""Workload plugin interface for the cycle-level engine (``core.sim``).

A *workload* owns what each core *runs*: a small per-core **program** of
micro-ops that the engine interprets with a per-core program counter.

A :class:`Program` is a static table of ``length`` micro-op steps.  Each
step is an atomic phase::

    <pre_mult*work + pre_add cycles of local work>
    ATOMIC(addr_mode, addr_arg)          # kind = K_ATOMIC
        with mod_mult*modify + mod_add cycles between load and store
  or
    BARRIER-arrival atomic, then wait    # kind = K_BARRIER

Address streams:

=============  =========================================================
ADDR_UNIFORM   counter-hash uniform over ``n_addrs``
ADDR_FIXED     ``addr_arg % n_addrs``
ADDR_ZIPF      bounded power-law over ``n_addrs`` with skew
               ``zipf_skew/100`` (:func:`zipf_index`)
=============  =========================================================

A ``K_BARRIER`` step issues its arrival atomic through the active
protocol, then parks the core in ``BARWAIT`` until every participating
core has arrived; the engine then releases all waiters with one
broadcast message each and one response latency.

Completing the last step wraps the program counter and counts one
completed *op*.  ``check`` validates a result dict host-side (numpy),
with the completion trace (``trace_step``: the retired step's id, or -1)
where the run recorded one.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# micro-op kinds
K_ATOMIC, K_BARRIER = 0, 1
# address-stream modes
ADDR_UNIFORM, ADDR_FIXED, ADDR_ZIPF = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Program:
    """Static per-core micro-op table (tuples of ints, one entry per
    step)."""
    kind: Tuple[int, ...]
    pre_mult: Tuple[int, ...]       # local work = pre_mult*work + pre_add
    pre_add: Tuple[int, ...]
    addr_mode: Tuple[int, ...]
    addr_arg: Tuple[int, ...]
    mod_mult: Tuple[int, ...]       # modify  = mod_mult*modify + mod_add
    mod_add: Tuple[int, ...]

    def __post_init__(self):
        L = len(self.kind)
        if L < 1:
            raise ValueError("empty program")
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if len(v) != L:
                raise ValueError(f"field {f.name} has length {len(v)} != {L}")
        for k, m in zip(self.kind, self.addr_mode):
            if k not in (K_ATOMIC, K_BARRIER):
                raise ValueError(f"unknown micro-op kind {k}")
            if k == K_BARRIER and m != ADDR_FIXED:
                raise ValueError("barrier steps need a FIXED address")
            if m not in (ADDR_UNIFORM, ADDR_FIXED, ADDR_ZIPF):
                raise ValueError(f"unknown address mode {m}")

    @property
    def length(self) -> int:
        return len(self.kind)

    def tables(self) -> Dict[str, np.ndarray]:
        """The table as int32 numpy arrays (the engine folds them)."""
        return {f.name: np.asarray(getattr(self, f.name), np.int32)
                for f in dataclasses.fields(self)}


def zipf_index(h24: torch.Tensor, n_addrs: int, skew_pct: int,
               traced: bool = False) -> torch.Tensor:
    """Map a 24-bit hash to a Zipf-like address in ``[0, n_addrs)``.

    Inverse CDF of the bounded continuous power law with density
    ∝ x^(-s) on [1, n+1): ``x = (1 + u*((n+1)^(1-s) - 1))^(1/(1-s))``
    with the log-uniform limit ``(n+1)^u`` near s = 1; address =
    ``floor(x) - 1``.  ``skew_pct`` is ``100*s``.

    Bit for bit the reference's stream, which its XLA CPU build computes
    with glibc's ``powf`` and with ``1 + u*c`` contracted into one fused
    multiply-add.  At ``skew_pct=0`` that is ``fmaf(u, n_addrs, 1)``:
    ``u*n_addrs + 1`` is exact in float64 (``u`` has 24 significant bits,
    ``n_addrs`` far fewer than 29), so rounding it once to float32 is the
    fused multiply-add.  At a skew the address is a nondecreasing step function
    of the hash, and the count of :func:`zipf_thresholds` at or below
    ``h24`` gives it.  ``traced`` picks the reference's form: ``False``
    for a single run (``sync.run``), ``True`` for a sweep (``Study``),
    where the reference's scalars are traced and ``1 - s`` is contracted
    too; the two agree at skew 0 and at 100 (the log-uniform limit).
    """
    if n_addrs <= 1:
        return torch.zeros(h24.shape, dtype=torch.int32, device=h24.device)
    if skew_pct == 0:
        u = h24.to(torch.float64) * (1.0 / (1 << 24))
        x = (u * n_addrs + 1.0).to(torch.float32)
        return (torch.floor(x).to(torch.int32) - 1).clamp_(0, n_addrs - 1)
    thr = _thresholds_on(n_addrs, skew_pct, traced, h24.device)
    return torch.searchsorted(thr, h24.to(torch.int64),
                              right=True).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _thresholds_on(n_addrs: int, skew_pct: int, traced: bool, device):
    return torch.from_numpy(zipf_thresholds(n_addrs, skew_pct, traced)
                            .astype(np.int64)).to(device)


#: hashes of the stream: ``h24`` lies in ``[0, HASH_SPAN)``
HASH_SPAN = 1 << 24


@functools.lru_cache(maxsize=1)
def _libm():
    """glibc's ``powf`` and ``fmaf`` (the C library the reference's XLA
    CPU build calls for float32 ``pow``)."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    fns = []
    for name, nargs in (("powf", 2), ("fmaf", 3)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_float] * nargs
        fn.restype = ctypes.c_float
        fns.append(fn)
    return tuple(fns)


def zipf_address_fn(n_addrs: int, skew_pct: int, traced: bool):
    """The reference's ``zipf_index`` of one hash at a skew, as a Python
    function of ``h`` in ``[0, HASH_SPAN)``, computed with glibc's
    ``powf``/``fmaf``:

    ``top = n+1``; ``om = 1 - skew*0.01`` (``fmaf(-skew, 0.01, 1)`` when
    ``traced``); near 1 (``|om| < 1e-3``) ``x = powf(top, u)``, else
    ``x = powf(fmaf(u, powf(top, om) - 1, 1), 1/om)``; the address is
    ``floor(x) - 1`` clamped to ``[0, n)``.  Every step is float32."""
    powf, fmaf = _libm()
    f32 = np.float32
    top = f32(n_addrs) + f32(1.0)
    if traced:
        om = f32(fmaf(-float(skew_pct), float(f32(0.01)), 1.0))
    else:
        om = f32(1.0) - f32(skew_pct) * f32(0.01)
    hi = n_addrs - 1
    if abs(float(om)) < 1e-3:
        t = float(top)

        def addr(h: int) -> int:
            return min(max(math.floor(powf(t, h * 2.0**-24)) - 1, 0), hi)
    else:
        c = float(f32(powf(float(top), float(om))) - f32(1.0))
        inv = float(f32(1.0) / om)

        def addr(h: int) -> int:
            x = powf(fmaf(h * 2.0**-24, c, 1.0), inv)
            return min(max(math.floor(x) - 1, 0), hi)
    return addr, float(top), float(om)


@functools.lru_cache(maxsize=256)
def zipf_thresholds(n_addrs: int, skew_pct: int,
                    traced: bool = False) -> np.ndarray:
    """The skewed stream as its steps: an int32 array ``T`` of
    ``n_addrs - 1`` entries, ``T[k-1]`` the least hash whose address
    (:func:`zipf_address_fn`) reaches ``k``, or ``HASH_SPAN`` where none
    does.  ``zipf_index`` of ``h`` is then the count of ``T`` at or below
    ``h``.  A float64 inverse of the power law guesses each threshold
    and a search on the float32 function settles it; each threshold is
    checked (the address just below it is under ``k``, at it at least
    ``k``) and the table must be nondecreasing, else ``ValueError``.
    Cached per ``(n_addrs, skew_pct, traced)``; the array is read-only."""
    addr_of, top, om = zipf_address_fn(n_addrs, skew_pct, traced)
    memo: Dict[int, int] = {}

    def addr(h: int) -> int:
        if h not in memo:
            memo[h] = addr_of(h)
        return memo[h]

    k = np.arange(1, n_addrs, dtype=np.float64)
    if abs(om) < 1e-3:
        guess = np.log(k + 1.0) / math.log(top)
    else:
        guess = ((k + 1.0) ** om - 1.0) / (top ** om - 1.0)
    guess = np.clip(np.ceil(guess * HASH_SPAN), 0, HASH_SPAN).astype(np.int64)
    out = np.empty(n_addrs - 1, dtype=np.int64)
    for j, g in enumerate(guess.tolist()):
        want = j + 1

        def reached(h: int) -> bool:
            return h >= HASH_SPAN or addr(h) >= want

        # bracket: reached(hi) and not reached(lo) (lo = -1: none below)
        step = 1
        if reached(g):
            hi, lo = g, g - 1
            while lo >= 0 and reached(lo):
                hi, step = lo, step * 2
                lo = hi - step
            lo = max(lo, -1)
        else:
            lo, hi = g, min(g + 1, HASH_SPAN)
            while not reached(hi):
                lo, step = hi, step * 2
                hi = min(lo + step, HASH_SPAN)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if reached(mid):
                hi = mid
            else:
                lo = mid
        out[j] = hi
    for j, t in enumerate(out.tolist()):
        want = j + 1
        if (t > 0 and addr(t - 1) >= want) or (t < HASH_SPAN
                                                and addr(t) < want):
            raise ValueError(f"zipf threshold {want} of ({n_addrs}, "
                             f"{skew_pct}, traced={traced}) does not hold")
    if np.any(np.diff(out) < 0):
        raise ValueError(f"zipf thresholds of ({n_addrs}, {skew_pct}, "
                         f"traced={traced}) decrease")
    out = out.astype(np.int32)
    out.flags.writeable = False
    return out


def zipf_factors(n_addrs: int, skew_pct: int):
    """The skew-0 stream's factor, ``c = n_addrs`` in float32, as the
    engine kernel takes it: its address of hash ``h`` is
    ``floor(fmaf(h * 2^-24, c, 1)) - 1`` clamped.  Other skews use
    :func:`zipf_thresholds` and have no factor (``None``)."""
    return float(np.float32(n_addrs)) if skew_pct == 0 else None


class Workload:
    """Base workload plugin.  Subclasses compile a :class:`Program` from
    the static ``SimParams`` and validate results host-side."""

    name: str = ""
    #: smallest ``n_addrs`` the program needs to keep its fixed
    #: addresses distinct
    min_addrs: int = 1
    #: canonical ``SimParams`` overrides for this workload's scenario
    scenario: Dict[str, int] = {}

    def program(self, p) -> Program:
        raise NotImplementedError

    # ---- host-side conservation laws ----
    def check(self, p, res: Dict[str, Any],
              trace: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Assert this workload's invariants on a result dict: each
        completed atomic retired on exactly one address, and the
        latency histogram carries exactly the retired-atomic count."""
        addr_ops = np.asarray(res["addr_ops"])
        atomics = int(np.asarray(res["opc"]).sum())
        assert int(addr_ops.sum()) == atomics, \
            f"address histogram mass {int(addr_ops.sum())} != {atomics}"
        if "lat_hist" in res:
            lat_mass = int(np.asarray(res["lat_hist"]).sum())
            assert lat_mass == atomics, \
                f"latency histogram mass {lat_mass} != {atomics}"
        return {"atomics": atomics, "ops": int(np.asarray(res["ops"]).sum())}

    # ---- trace helpers for subclasses ----
    @staticmethod
    def _per_core_steps(trace: np.ndarray):
        """Yield (core, step-id sequence in completion order)."""
        for c in range(trace.shape[1]):
            col = trace[:, c]
            yield c, col[col >= 0]
