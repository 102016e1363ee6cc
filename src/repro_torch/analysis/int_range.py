"""Integer-range analyzer: symbolic bounds for the port's integer
arithmetic over the certified Spec envelope (``sync.spec.
ANALYSIS_BOUNDS``).

The reference proves its int32 fused arbitration key; the port has no
such key (the plain step takes a lexicographic min, the CUDA kernels a
packed 64-bit one), so this pass proves theorems about the port's own
integers instead, each a checked statement rather than a belief:

* **sentinel** — arrival stamps ``[0, cycles - 1]`` stay below the
  non-contending stamp ``_BIG = 2**31 - 1`` (``core/sim.py``,
  ``kernels/engine_step/ref.py``) for every horizon in the envelope, so
  a real request never ties with "no request".
* **packed-key** — ``packed_key`` (``csrc/engine_step.cu``) puts a
  non-negative int32 stamp in the high 32 bits and ``rot < n`` in the low
  32: the low field never reaches 2^32, so the packed order is the
  lexicographic order of (arr, rot).
* **level-count** — the run kernel's acceptance pass packs each
  topology level's count of crossing requesters (at most ``n``) into a
  16-bit field; its refusal at ``n >= MAX_TOPO_CORES`` is **sound**
  (every admitted count fits) and **tight** (the first refused core
  count would wrap).
* **hash-int64** — ``core/sim.py::_hash`` emulates the reference's
  uint32 multiply in int64 on the constant's 16-bit halves: no int64
  intermediate overflows, and the split equals the uint32 product.
* **backoff-overflow** — the backoff timer ``(backoff << min(streak,
  exp_cap) - 1) + jitter`` and the run kernel's ``shl32`` table
  (``_bo_tab``) stay inside int32, without a wrap, over the envelope.
* **envelope** — ``ANALYSIS_BOUNDS`` names real ``SimParams`` fields
  and its floors match the engine's own validation floors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import torch

from repro_torch.analysis.report import Finding, PassReport
from repro_torch.core import sim
from repro_torch.core.protocols import get as get_protocol
from repro_torch.core.workloads import get as get_workload
from repro_torch.kernels import _build
from repro_torch.kernels.engine_step import kernel as es_kernel
from repro_torch.kernels.engine_step import ref as es_ref
from repro_torch.sync.spec import ANALYSIS_BOUNDS

INT32_MAX = 2**31 - 1
INT64_MAX = 2**63 - 1
UINT32_MAX = 2**32 - 1

#: bits of each level's count in the acceptance pass's packed word, and
#: the statement of ``csrc/engine_step.cu`` that reads them
LEVEL_FIELD_BITS = 16
LEVEL_FIELD_READ = "xp1 >> (16 * l) & 0xffffu"
#: the halves ``core/sim.py::_hash`` splits the Knuth constant into
HASH_HALF_BITS = 16


@dataclasses.dataclass(frozen=True)
class Interval:
    """Inclusive integer interval with conservative arithmetic (exact
    for the monotone non-negative operations the engine uses)."""
    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    def __add__(self, o: "Interval") -> "Interval":
        o = _as_iv(o)
        return Interval(self.lo + o.lo, self.hi + o.hi)

    def __mul__(self, o: "Interval") -> "Interval":
        o = _as_iv(o)
        corners = [self.lo * o.lo, self.lo * o.hi,
                   self.hi * o.lo, self.hi * o.hi]
        return Interval(min(corners), max(corners))

    def shl(self, o: "Interval") -> "Interval":
        o = _as_iv(o)
        if self.lo < 0 or o.lo < 0:
            raise ValueError("shift bounds require non-negative operands")
        return Interval(self.lo << o.lo, self.hi << o.hi)

    def fits_int32(self) -> bool:
        return -(2**31) <= self.lo and self.hi <= INT32_MAX

    def fits_int64(self) -> bool:
        return -(2**63) <= self.lo and self.hi <= INT64_MAX


def _as_iv(x) -> Interval:
    return x if isinstance(x, Interval) else Interval(int(x), int(x))


def _report(subject: str) -> PassReport:
    return PassReport(pass_name="range", subject=subject)


def _flag(rep: PassReport, rule: str, detail: str) -> None:
    rep.findings.append(Finding("range", rule, rep.subject, detail))


# ---- the non-contending sentinel -----------------------------------------
def stamp_interval(cycles: int) -> Interval:
    """Arrival stamps of a run: the cycle a request was accepted."""
    return Interval(0, cycles - 1)


def check_sentinel() -> PassReport:
    rep = _report("arrival-sentinel")
    t0 = time.perf_counter()
    if sim._BIG != es_ref._BIG:
        _flag(rep, "sentinel", f"the engine's sentinel {sim._BIG} and the "
                               f"step's {es_ref._BIG} differ")
    big = min(sim._BIG, es_ref._BIG)
    iv = stamp_interval(ANALYSIS_BOUNDS["cycles"][1])
    rep.stats.update(stamps=(iv.lo, iv.hi), sentinel=big)
    if not iv.hi < big:
        _flag(rep, "sentinel",
              f"arrival stamps {iv} reach the no-request sentinel {big} "
              f"inside the envelope (cycles <= "
              f"{ANALYSIS_BOUNDS['cycles'][1]}): a request would tie with "
              f"no request")
    rep.wall_s = time.perf_counter() - t0
    return rep


# ---- the packed arbitration key --------------------------------------------
def packed_key(arr: int, i: int, shift: int, n: int) -> int:
    """``csrc/engine_step.cu::packed_key`` in Python integers."""
    rot = i + shift if i + shift < n else i + shift - n
    return ((arr & UINT32_MAX) << 32) | (rot & UINT32_MAX)


def check_packed_key() -> PassReport:
    """The low field ``rot = (i + shift) mod n`` (``i, shift < n``) stays
    below 2^32 and the stamp is non-negative, so ``(arr << 32) | rot``
    orders as (arr, rot) lexicographically; checked as intervals over the
    envelope and on its corner keys."""
    rep = _report("packed-arbitration-key")
    t0 = time.perf_counter()
    n_hi = ANALYSIS_BOUNDS["n_cores"][1]
    arr = stamp_interval(ANALYSIS_BOUNDS["cycles"][1])
    rot = Interval(0, n_hi - 1)
    key = arr.shl(32) + rot
    rep.stats.update(rot=(rot.lo, rot.hi), key=(key.lo, key.hi))
    if rot.hi > UINT32_MAX:
        _flag(rep, "packed-key",
              f"rot reaches {rot.hi} at n <= {n_hi}: the low field "
              f"carries into the stamp")
    if arr.lo < 0 or arr.hi > INT32_MAX:
        _flag(rep, "packed-key", f"stamps {arr} are not non-negative "
                                 f"int32: the unsigned cast reorders them")
    if key.hi >= 2**64:
        _flag(rep, "packed-key", f"packed keys {key} leave 64 bits")
    # the corners: each pair's packed order is its lexicographic order
    corners = sorted({(a, r) for a in (arr.lo, arr.lo + 1, arr.hi - 1,
                                       arr.hi)
                      for r in (0, 1, rot.hi - 1, rot.hi)})
    n = rot.hi + 1
    keys = [packed_key(a, r, 0, n) for a, r in corners]
    if keys != sorted(keys) or len(set(keys)) != len(keys):
        _flag(rep, "packed-key", "the packed keys of the envelope's "
                                 "corners do not sort as (arr, rot)")
    rep.wall_s = time.perf_counter() - t0
    return rep


# ---- the per-level counts of the topology acceptance -----------------------
def _admits(n: int) -> bool:
    """Whether the run kernel takes a cluster2 run of ``n`` cores."""
    p = sim.SimParams(protocol="colibri", n_cores=n, n_addrs=1, cycles=1,
                      topology="cluster2", clusters=2)
    try:
        es_kernel.run_scalars(p, get_protocol("colibri"),
                              get_workload(p.workload).program(p))
    except NotImplementedError:
        return False
    return True


def check_level_count() -> PassReport:
    """Counts of crossing requesters are at most ``n``.  Sound: the
    largest core count the run kernel admits on a topology has its counts
    fit ``LEVEL_FIELD_BITS`` bits (and the packed word 32).  Tight: the
    next core count, which it refuses, would wrap."""
    rep = _report("level-count")
    t0 = time.perf_counter()
    field_max = (1 << LEVEL_FIELD_BITS) - 1
    levels = es_kernel.MAX_LEVELS
    limit = es_kernel.MAX_TOPO_CORES
    src = (_build.PKG / "csrc" / "engine_step.cu").read_text()
    if LEVEL_FIELD_READ not in src:
        _flag(rep, "level-count",
              f"engine_step.cu no longer reads the level counts as "
              f"{LEVEL_FIELD_READ!r}: the field width is unproved")
    admitted, refused = limit - 1, limit
    rep.stats.update(limit=limit, field_bits=LEVEL_FIELD_BITS,
                     max_admitted=admitted)
    if not _admits(admitted):
        _flag(rep, "level-count",
              f"the run kernel refuses {admitted} cores on a topology, "
              f"below its stated limit {limit}")
    if _admits(refused):
        _flag(rep, "level-count",
              f"the run kernel admits {refused} cores on a topology, its "
              f"stated limit")
    count = Interval(0, admitted)
    word = count.shl(LEVEL_FIELD_BITS * (levels - 1)) + count
    if count.hi > field_max or word.hi > UINT32_MAX:
        _flag(rep, "level-count",
              f"unsound: {admitted} admitted cores give level counts "
              f"{count} beyond a {LEVEL_FIELD_BITS}-bit field")
    if refused <= field_max:
        _flag(rep, "level-count",
              f"not tight: {refused} cores are refused although their "
              f"counts fit a {LEVEL_FIELD_BITS}-bit field")
    rep.wall_s = time.perf_counter() - t0
    return rep


# ---- the Knuth hash in int64 ------------------------------------------------
def hash_intervals() -> dict:
    """Ranges of ``_hash``'s int64 intermediates: ``x & 0xffffffff``,
    ``x * (K & low)``, ``x * (K >> half)`` and their masked sum, the
    constant split at ``HASH_HALF_BITS`` (0: one product, no split)."""
    half_bits = HASH_HALF_BITS
    k = sim._KNUTH
    x = Interval(0, sim._MASK32)
    low = (1 << half_bits) - 1
    lo = x * (k & low if half_bits else k)
    hi = x * (k >> half_bits if half_bits else 0)
    return dict(x=x, lo=lo, hi=hi,
                sum=lo + Interval(0, (low << half_bits) & sim._MASK32))


def check_hash() -> PassReport:
    rep = _report("hash-int64")
    t0 = time.perf_counter()
    ivs = hash_intervals()
    rep.stats.update({k: (v.lo, v.hi) for k, v in ivs.items()})
    bad = [k for k, v in ivs.items() if not v.fits_int64()]
    if bad:
        _flag(rep, "hash-int64",
              f"_hash's int64 intermediates {bad} overflow with the "
              f"constant split at {HASH_HALF_BITS} bits: "
              + ", ".join(f"{k} {ivs[k]}" for k in bad))
    # the split equals the uint32 product on the input corners
    xs = [0, 1, 2**31 - 1, 2**31, sim._MASK32, -1, -(2**31), -(2**63),
          2**63 - 1]
    got = sim._hash(torch.tensor(xs, dtype=torch.int64)).tolist()
    want = [((x & sim._MASK32) * sim._KNUTH & sim._MASK32) >> 8 for x in xs]
    if got != want:
        _flag(rep, "hash-int64", f"_hash({xs}) = {got}, the uint32 product "
                                 f"gives {want}")
    rep.wall_s = time.perf_counter() - t0
    return rep


# ---- backoff timer ----------------------------------------------------------
def backoff_interval(backoff_hi: int, backoff_exp_hi: int) -> Interval:
    """Range of ``(backoff << max(streak - 1, 0)) + jitter`` with
    ``streak <= exp_cap <= backoff_exp`` and ``jitter = hash % 32``."""
    shift = Interval(0, max(backoff_exp_hi - 1, 0))
    return Interval(0, backoff_hi).shl(shift) + Interval(0, 31)


def check_backoff() -> PassReport:
    rep = _report("backoff-timer")
    t0 = time.perf_counter()
    bo_hi = ANALYSIS_BOUNDS["backoff"][1]
    be_hi = ANALYSIS_BOUNDS["backoff_exp"][1]
    iv = backoff_interval(bo_hi, be_hi)
    rep.stats["interval"] = (iv.lo, iv.hi)
    if not iv.fits_int32():
        _flag(rep, "backoff-overflow",
              f"backoff timer interval {iv} leaves int32 inside the "
              f"envelope (backoff<={bo_hi}, backoff_exp<={be_hi})")
    # the run kernel's table: shl32 without a wrap at the envelope's top
    tab = es_kernel._bo_tab(bo_hi, be_hi)
    exact = [bo_hi << max(min(k, be_hi) - 1, 0) for k in range(len(tab))]
    if list(tab) != exact:
        _flag(rep, "backoff-overflow",
              f"_bo_tab({bo_hi}, {be_hi}) wraps: {max(tab)} against "
              f"{max(exact)}")
    rep.wall_s = time.perf_counter() - t0
    return rep


# ---- envelope consistency ---------------------------------------------------
def check_envelope() -> PassReport:
    """``ANALYSIS_BOUNDS`` must name real ``SimParams`` fields and its
    lower bounds must match the engine's own validation floor — the
    certificate is meaningless if it covers Specs the engine rejects
    (or misses values it accepts)."""
    rep = _report("analysis-envelope")
    t0 = time.perf_counter()
    fields = {f.name for f in dataclasses.fields(sim.SimParams)}
    engine_lo = dict(sim.SimParams._BOUNDS)
    for name, (lo, hi) in ANALYSIS_BOUNDS.items():
        if name not in fields:
            _flag(rep, "envelope", f"{name!r} is not a SimParams field")
            continue
        if lo > hi:
            _flag(rep, "envelope", f"{name}: empty envelope [{lo}, {hi}]")
        if name in engine_lo and lo < engine_lo[name]:
            _flag(rep, "envelope",
                  f"{name}: envelope floor {lo} is below the engine's "
                  f"validation floor {engine_lo[name]} — certifying "
                  f"values the engine rejects")
    missing = [f for f, _ in sim.SimParams._BOUNDS
               if f not in ANALYSIS_BOUNDS]
    if missing:
        _flag(rep, "envelope",
              f"engine-validated fields {missing} have no certification "
              f"envelope entry")
    rep.wall_s = time.perf_counter() - t0
    return rep


def check_all(quick: bool = False) -> List[PassReport]:
    del quick                        # the range pass is always cheap
    return [check_sentinel(), check_packed_key(), check_level_count(),
            check_hash(), check_backoff(), check_envelope()]


__all__ = ["Interval", "backoff_interval", "check_all", "check_backoff",
           "check_envelope", "check_hash", "check_level_count",
           "check_packed_key", "check_sentinel", "hash_intervals",
           "packed_key", "stamp_interval"]
