"""``repro_torch.analysis`` — static analysis and verification passes.

The port of ``repro.analysis``; torch, numpy and the standard library
only.  Three passes, gated by ``python -m repro_torch.analysis --all``:

* ``model`` (:mod:`repro_torch.analysis.model_check`) — explicit-state
  model checker: drives every registered protocol's hooks
  (``on_access`` and its fused twin, ``on_wake``, ``held``/
  ``on_timeout``) over exhaustive interleavings of tiny configurations
  and enforces the protocol's declared
  :class:`~repro_torch.core.protocols.base.Contract` (mutual exclusion,
  no lost wakeups, polling- and retry-freedom, queue conservation,
  watchdog-recovery soundness).  On the card, ``chip_smoke.py`` puts the
  ``engine_step`` kernel in the fused twin's place.
* ``trace`` (:mod:`repro_torch.analysis.trace_safety`) — the checks
  that need no framework: the result keys' budget, the kernel instance
  of each feature and the card path's result layout, and the static
  sweep axes.  The reference's jaxpr audits have no port (the port has
  no jaxpr).
* ``range`` (:mod:`repro_torch.analysis.int_range`) — integer-range
  proofs: the arrival sentinel, the packed arbitration key, the
  topology level counts, the int64 hash, the backoff table, and the
  certification envelope against the engine's validation bounds.

Programmatic entry points::

    from repro_torch.analysis import run_passes
    reports = run_passes(["model", "trace", "range"])
    ok = all(r.ok for r in reports)
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.analysis import int_range, model_check, trace_safety
from repro_torch.analysis.report import (Finding, PassReport, all_findings,
                                         summarize)

PASSES = ("model", "trace", "range")


def run_passes(passes: Optional[List[str]] = None, quick: bool = False,
               protocols: Optional[List[str]] = None
               ) -> List[PassReport]:
    """Run the selected passes (default: all three) and return their
    reports; a report with findings means the gate fails."""
    sel = list(passes) if passes else list(PASSES)
    unknown = [p for p in sel if p not in PASSES]
    if unknown:
        raise ValueError(f"unknown pass(es) {unknown}; available: "
                         f"{', '.join(PASSES)}")
    reports: List[PassReport] = []
    if "model" in sel:
        reports += model_check.check_all(quick=quick, protocols=protocols)
    if "trace" in sel:
        reports += trace_safety.check_all(quick=quick, protocols=protocols)
    if "range" in sel:
        reports += int_range.check_all(quick=quick)
    return reports


__all__ = ["Finding", "PassReport", "PASSES", "run_passes",
           "all_findings", "summarize", "model_check", "trace_safety",
           "int_range"]
