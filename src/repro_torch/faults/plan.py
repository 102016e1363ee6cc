"""``FaultPlan`` — the declarative, deterministic fault schedule.

The paper's central trade is replacing polling with sleeping: every
LRwait/SCwait sleeper's forward progress *depends* on the reservation
owner, so a stalled core or a dropped wakeup silently deadlocks the
whole queue — a failure mode retry-based LRSC does not have.  A
``FaultPlan`` makes that property testable: it describes WHAT goes
wrong (cores die or stall, NoC messages drop, banks stall) and WHAT
defends against it (the per-bank reservation watchdog, the
forward-progress detector), as a frozen, hashable, JSON-round-trippable
value that ``Spec(faults=...)`` lowers into the engine.

Everything is **static and seed-derived**: victim sets are drawn
host-side from ``fault_seed`` (``numpy`` RNG) and the Bernoulli
message-drop stream is a counter hash of (lane, cycle, ``fault_seed``),
so the same plan always injects the same faults.  The port's engine
runs only the empty plan so far (ROADMAP item A5); this module is the
reference's, so that ``Spec`` keeps its shape and JSON.

Injection knobs
---------------
* ``n_kill`` / ``kill_cyc`` / ``kill_holder`` — ``n_kill`` cores freeze
  permanently at/after ``kill_cyc``.  With ``kill_holder=1`` (the
  adversarial default) the victims are the first ``n_kill`` cores to be
  GRANTED a reservation/lock at or after ``kill_cyc`` — each dies while
  holding, the exact scenario that wedges sleep-based protocols.  With
  ``kill_holder=0`` victims are a uniform seed-derived core subset.
* ``n_stall`` / ``stall_cyc`` / ``stall_dur`` — ``n_stall`` uniform
  victims freeze for the window ``[stall_cyc, stall_cyc + stall_dur)``
  and then resume (transient GC-pause-style stalls).
* ``msg_drop_bp`` — Bernoulli drop, in basis points (per 10 000), on
  NoC request messages and on in-flight wakeup messages (the "lost
  wakeup").  Dropped requests retransmit (the core stays in REQ);
  dropped wakeups are only recovered by the watchdog.
* ``n_bank_stall`` / ``bank_stall_cyc`` / ``bank_stall_dur`` — that
  many banks accept no requests during the window (arbitration skips
  them; parked requests wait).

Recovery knobs
--------------
* ``watchdog_cyc`` — per-bank reservation timeout: a bank held with no
  service progress for this many cycles triggers the protocol's
  ``on_timeout`` hook (evict a dead owner, re-send a lost wakeup,
  force-free a wedged lock).  0 disables recovery — faults then
  deadlock exactly as the unprotected protocol would.
* ``progress_cyc`` — forward-progress watchdog: if NO core retires an
  op for this many cycles the run is flagged (``halt_cyc`` in stats →
  ``progress_ok=False``) instead of silently burning the horizon.
  0 picks ``max(2000, 4 * watchdog_cyc)`` automatically whenever any
  fault machinery is on.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: basis-point denominator for the Bernoulli message-drop draw
DROP_DENOM = 10_000

#: RNG stream salts for the three host-drawn victim sets
_SALT_KILL, _SALT_STALL, _SALT_BANK = 1, 2, 3


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic fault schedule + recovery policy (see module
    docstring).  ``FaultPlan()`` is the no-fault plan: the engine
    statically elides every fault branch for it."""
    n_kill: int = 0           # cores killed (permanent freeze)
    kill_cyc: int = 0         # first cycle a kill may take effect
    kill_holder: int = 1      # 1: kill grant holders; 0: uniform victims
    n_stall: int = 0          # cores transiently frozen
    stall_cyc: int = 0        # stall window start
    stall_dur: int = 0        # stall window length (cycles)
    msg_drop_bp: int = 0      # request/wakeup drop rate, per 10 000
    n_bank_stall: int = 0     # banks refusing service
    bank_stall_cyc: int = 0   # bank-stall window start
    bank_stall_dur: int = 0   # bank-stall window length (cycles)
    fault_seed: int = 0       # seed of every victim draw / drop stream
    watchdog_cyc: int = 0     # reservation timeout (0 = no recovery)
    progress_cyc: int = 0     # livelock/deadlock flag (0 = auto)

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if (not isinstance(v, (int, np.integer)) or isinstance(v, bool)
                    or v < 0):
                raise ValueError(
                    f"FaultPlan.{f.name} must be an int >= 0 (got {v!r})")
        if self.kill_holder not in (0, 1):
            raise ValueError(
                f"kill_holder must be 0 or 1 (got {self.kill_holder!r})")
        if self.msg_drop_bp > DROP_DENOM:
            raise ValueError(
                f"msg_drop_bp is basis points, must be <= {DROP_DENOM} "
                f"(got {self.msg_drop_bp})")
        if self.n_stall > 0 and self.stall_dur < 1:
            raise ValueError("n_stall > 0 needs stall_dur >= 1")
        if self.n_bank_stall > 0 and self.bank_stall_dur < 1:
            raise ValueError("n_bank_stall > 0 needs bank_stall_dur >= 1")

    # ---- static gates ---------------------------------------------------
    @property
    def injects(self) -> bool:
        """Does this plan inject any fault at all?"""
        return (self.n_kill > 0 or self.n_stall > 0
                or self.msg_drop_bp > 0 or self.n_bank_stall > 0)

    @property
    def enabled(self) -> bool:
        """Does the engine need ANY fault machinery (injection, recovery
        or detection) for this plan?  False ⇒ the whole subsystem is
        statically elided and the trace is bit-identical to pre-fault."""
        return (self.injects or self.watchdog_cyc > 0
                or self.progress_cyc > 0)

    def progress_threshold(self) -> int:
        """The effective forward-progress flag threshold (cycles with no
        retirement anywhere): ``progress_cyc``, or the conservative
        ``max(2000, 4 * watchdog_cyc)`` default when 0."""
        if self.progress_cyc > 0:
            return self.progress_cyc
        return max(2000, 4 * self.watchdog_cyc)

    # ---- host-side schedule derivation ----------------------------------
    def victim_mask(self, size: int, count: int, salt: int) -> np.ndarray:
        """``(size,)`` bool mask with ``min(count, size)`` True lanes,
        drawn without replacement from ``(fault_seed, salt)`` — the one
        sampler every victim set uses, so a plan's schedule is a pure
        function of the plan (numpy RNG; nothing enters the scan)."""
        mask = np.zeros((size,), bool)
        k = min(count, size)
        if k > 0:
            rng = np.random.default_rng([self.fault_seed, salt])
            mask[rng.choice(size, size=k, replace=False)] = True
        return mask

    def kill_mask(self, n: int) -> np.ndarray:
        """(n,) uniform-kill victims (``kill_holder=0`` mode)."""
        return self.victim_mask(n, self.n_kill, _SALT_KILL)

    def stall_mask(self, n: int) -> np.ndarray:
        """(n,) transient-stall victims."""
        return self.victim_mask(n, self.n_stall, _SALT_STALL)

    def bank_stall_mask(self, a: int) -> np.ndarray:
        """(a,) bank-stall victims (over the static bank allocation)."""
        return self.victim_mask(a, self.n_bank_stall, _SALT_BANK)
