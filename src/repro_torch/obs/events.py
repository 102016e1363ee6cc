"""``EventLog`` — the typed event-trace view of a ``record_trace`` run
(the port's copy of ``repro.obs.events``).

``record_trace=True`` makes the engine emit four per-cycle traces:

``trace_step``/``trace_wait``
    ``(cycles, n)`` int32 — which micro-op retired on each core each
    cycle (-1 = none) and its first-issue-to-retire latency (the
    pre-existing linearizability-check arrays).
``trace_state``
    ``(cycles, n)`` int8 — each core's engine state at the END of each
    cycle (``schema.STATE_NAMES`` codes).
``trace_qlen``
    ``(cycles, a)`` int32 — each bank's reservation-queue depth at the
    end of each cycle (all-zero for queueless protocols).

This module run-length-encodes the state trace into **spans** — the
(core, state, start, length) intervals Perfetto renders as tracks — and
exposes the retirements as a flat **completions** table.  The span view
is what makes the paper's behaviour *visible*: an LRSC run shows
BACKOFF spans (retry storms) where a Colibri run of the same workload
shows single SLEEP spans per contended op and none in BACKOFF.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import schema


@dataclasses.dataclass(frozen=True)
class Span:
    """One maximal run of a core staying in one state."""
    core: int
    state: int           # engine state code (schema.STATE_NAMES)
    start: int           # first cycle of the run
    length: int          # cycles spent in the state

    @property
    def name(self) -> str:
        return schema.STATE_NAMES.get(self.state, f"state{self.state}")


@dataclasses.dataclass(frozen=True)
class EventLog:
    """Typed event traces of one ``record_trace=True`` simulation."""
    step: np.ndarray                 # (cycles, n) int32, -1 = no retire
    wait: np.ndarray                 # (cycles, n) int32, -1 = no retire
    state: Optional[np.ndarray]      # (cycles, n) int8, or None (old runs)
    qlen: Optional[np.ndarray]       # (cycles, a) int32, or None

    # ---- construction ---------------------------------------------------
    @classmethod
    def from_result(cls, result: Any) -> "EventLog":
        """Build from a ``repro_torch.sync.Result`` (or a raw stats
        mapping)."""
        stats = getattr(result, "stats", result)
        if "trace_step" not in stats:
            raise ValueError(
                "result has no event trace: run with record_trace=True "
                "(e.g. Spec(..., record_trace=True))")
        get = (lambda k: np.asarray(stats[k]) if k in stats else None)
        return cls(step=np.asarray(stats["trace_step"]),
                   wait=np.asarray(stats["trace_wait"]),
                   state=get("trace_state"), qlen=get("trace_qlen"))

    @property
    def cycles(self) -> int:
        return self.step.shape[0]

    @property
    def n_cores(self) -> int:
        return self.step.shape[1]

    @property
    def n_addrs(self) -> int:
        return 0 if self.qlen is None else self.qlen.shape[1]

    # ---- completions ----------------------------------------------------
    def completions(self) -> Dict[str, np.ndarray]:
        """All retirements as a flat table: ``cycle``/``core`` of each
        retirement plus the retired micro-op index (``step``) and its
        issue-to-retire latency (``wait``), cycle-major order."""
        cyc, core = np.nonzero(self.step >= 0)
        return {"cycle": cyc.astype(np.int64),
                "core": core.astype(np.int64),
                "step": self.step[cyc, core].astype(np.int64),
                "wait": self.wait[cyc, core].astype(np.int64)}

    # ---- state spans -----------------------------------------------------
    def spans(self, core: Optional[int] = None,
              states: Optional[Tuple[int, ...]] = None) -> List[Span]:
        """Run-length-encoded state intervals, optionally restricted to
        one ``core`` and/or a tuple of state codes.  Requires the state
        trace (``trace_state``)."""
        if self.state is None:
            raise ValueError("no state trace recorded (trace_state "
                             "missing; re-run with record_trace=True on "
                             "a telemetry-era engine)")
        cores = range(self.n_cores) if core is None else (core,)
        out: List[Span] = []
        for c in cores:
            col = self.state[:, c]
            # boundaries of maximal constant runs
            brk = np.flatnonzero(col[1:] != col[:-1]) + 1
            starts = np.concatenate(([0], brk))
            ends = np.concatenate((brk, [col.shape[0]]))
            for s, e in zip(starts, ends):
                st = int(col[s])
                if states is None or st in states:
                    out.append(Span(core=int(c), state=st, start=int(s),
                                    length=int(e - s)))
        return out

    def span_counts(self, state: int) -> np.ndarray:
        """(n,) number of maximal spans each core spent in ``state`` —
        e.g. ``span_counts(BACKOFF)`` counts retry episodes per core
        (identically zero for the polling-free protocols)."""
        if self.state is None:
            raise ValueError("no state trace recorded")
        is_st = (self.state == state)
        entered = is_st & np.concatenate(
            (np.ones((1, self.n_cores), bool), ~is_st[:-1]), axis=0)
        return entered.sum(axis=0).astype(np.int64)

    def time_in_state(self, state: int) -> np.ndarray:
        """(n,) total cycles each core spent in ``state``."""
        if self.state is None:
            raise ValueError("no state trace recorded")
        return (self.state == state).sum(axis=0).astype(np.int64)
