"""Chrome-trace export: watch a simulation in Perfetto (the port's copy
of ``repro.obs.perfetto``; for the same result it writes the same
bytes).

:func:`export` turns one ``record_trace=True`` result into a Chrome
Trace Event JSON file loadable at https://ui.perfetto.dev (or
``chrome://tracing``): one track per core showing its engine-state
spans (SLEEP / BACKOFF / BARWAIT / REQ / ...), an instant marker per
atomic retirement, and one counter track per bank plotting its
reservation-queue depth.  One simulated cycle maps to one trace
microsecond, so the Perfetto timeline axis reads directly in cycles.

This is the first way to *watch* the paper's claims: load a Colibri and
an LRSC run of the same contended workload side by side and the LRSC
tracks fill with BACKOFF retry spans while the Colibri tracks show one
SLEEP span per contended op and zero retries
(the reference's ``examples/trace_perfetto.py`` generates exactly that
pair).

Span volume is bounded by construction — spans are maximal state runs,
so a track never holds more events than state *changes* — and WORK
spans (the between-atomics baseline) are skipped by default to keep
traces lean; pass ``include_work=True`` to render them too.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.obs.events import EventLog

#: Perfetto process ids: cores, banks and the NoC render as three
#: process groups
_PID_CORES = 1
_PID_BANKS = 2
_PID_NOC = 3

#: engine state code -> stable Perfetto slice color (color_name is a
#: documented Chrome-trace extension; viewers without it just ignore it)
_COLORS = {"SLEEP": "thread_state_sleeping",
           "BACKOFF": "terrible",
           "BARWAIT": "thread_state_iowait",
           "REQ": "thread_state_runnable",
           "RESP": "thread_state_running",
           "MOD": "thread_state_running",
           "WORK": "grey"}


def to_trace_events(result: Any, include_work: bool = False,
                    max_cores: Optional[int] = None) -> List[Dict]:
    """The Chrome ``traceEvents`` list for ``result`` (see
    :func:`export`).  ``max_cores`` caps how many core tracks are
    emitted (all by default) — banks are always all emitted."""
    log = EventLog.from_result(result)
    if log.state is None:
        raise ValueError(
            "result predates the state trace; re-run with "
            "record_trace=True to export a Perfetto trace")
    ev: List[Dict] = []
    ncores = log.n_cores if max_cores is None else min(max_cores,
                                                       log.n_cores)
    # ---- metadata: name the process/thread tracks -----------------------
    ev.append({"ph": "M", "pid": _PID_CORES, "name": "process_name",
               "args": {"name": "cores"}})
    ev.append({"ph": "M", "pid": _PID_BANKS, "name": "process_name",
               "args": {"name": "banks"}})
    for c in range(ncores):
        ev.append({"ph": "M", "pid": _PID_CORES, "tid": c,
                   "name": "thread_name", "args": {"name": f"core {c}"}})
    # ---- per-core state spans (ph "X": complete events) -----------------
    for span in log.spans():
        if span.core >= ncores:
            continue
        name = span.name
        if name == "WORK" and not include_work:
            continue
        e = {"ph": "X", "pid": _PID_CORES, "tid": span.core,
             "name": name, "cat": "state",
             "ts": span.start, "dur": span.length}
        color = _COLORS.get(name)
        if color:
            e["cname"] = color
        ev.append(e)
    # ---- retirement instants (ph "i") -----------------------------------
    comp = log.completions()
    for cyc, core, step, wait in zip(comp["cycle"], comp["core"],
                                     comp["step"], comp["wait"]):
        if core >= ncores:
            continue
        ev.append({"ph": "i", "pid": _PID_CORES, "tid": int(core),
                   "name": "retire", "cat": "atomic", "s": "t",
                   "ts": int(cyc),
                   "args": {"step": int(step), "wait_cycles": int(wait)}})
    # ---- fault-injection overlays ----------------------------------------
    # host-synthesized from the plan's deterministic schedule plus the
    # engine's dead_mask/halt_cyc outputs: DEAD spans on killed cores,
    # STALL spans over the scheduled stall windows, BANK_STALL spans on
    # stalled bank tracks, and one global instant when the forward-
    # progress watchdog flagged a halt
    spec = getattr(result, "spec", None)
    fp = getattr(spec, "faults", None) if spec is not None else None
    if fp is not None and fp.enabled:
        horizon = int(spec.costs.cycles)
        get = result.get if hasattr(result, "get") else (lambda k, d=None: d)
        dead = np.asarray(get("dead_mask", np.zeros(0, bool)))
        kill_ts = int(fp.kill_cyc if fp.n_kill else fp.stall_cyc)
        for c in np.flatnonzero(dead):
            if c >= ncores:
                continue
            # holder kills fire at the victim's first post-kill_cyc
            # ownership handoff; kill_cyc is the earliest possible start
            ev.append({"ph": "X", "pid": _PID_CORES, "tid": int(c),
                       "name": "DEAD", "cat": "fault", "cname": "black",
                       "ts": kill_ts, "dur": max(horizon - kill_ts, 1)})
        if fp.n_stall:
            dur = min(fp.stall_cyc + fp.stall_dur, horizon) - fp.stall_cyc
            for c in np.flatnonzero(fp.stall_mask(log.n_cores)):
                if c >= ncores or dur <= 0:
                    continue
                ev.append({"ph": "X", "pid": _PID_CORES, "tid": int(c),
                           "name": "STALL", "cat": "fault",
                           "cname": "terrible",
                           "ts": int(fp.stall_cyc), "dur": int(dur)})
        if fp.n_bank_stall and log.qlen is not None:
            dur = (min(fp.bank_stall_cyc + fp.bank_stall_dur, horizon)
                   - fp.bank_stall_cyc)
            for b in np.flatnonzero(fp.bank_stall_mask(log.qlen.shape[1])):
                if dur <= 0:
                    continue
                ev.append({"ph": "X", "pid": _PID_BANKS, "tid": int(b),
                           "name": "BANK_STALL", "cat": "fault",
                           "cname": "terrible",
                           "ts": int(fp.bank_stall_cyc), "dur": int(dur)})
        halt = int(np.asarray(get("halt_cyc", -1)))
        if halt >= 0:
            ev.append({"ph": "i", "pid": _PID_CORES, "name": "HALT",
                       "cat": "fault", "s": "g", "ts": halt,
                       "args": {"detail": "forward-progress watchdog: "
                                          "no retirement for the "
                                          "progress threshold"}})
    # ---- per-bank queue-depth counters (ph "C", emit-on-change) ---------
    if log.qlen is not None:
        q = log.qlen
        for b in range(q.shape[1]):
            col = q[:, b]
            # emit only cycles where the depth changes (plus cycle 0),
            # so an idle bank costs one event, not ``cycles``
            chg = np.concatenate(([0], np.flatnonzero(col[1:] != col[:-1])
                                  + 1))
            for cyc in chg:
                ev.append({"ph": "C", "pid": _PID_BANKS, "tid": int(b),
                           "name": f"bank {b} qlen", "ts": int(cyc),
                           "args": {"depth": int(col[cyc])}})
    # ---- NoC link-occupancy counters (windowed telemetry) ---------------
    # accepted messages split into intra-cluster (local) vs cross-cluster
    # traffic, one counter sample per telemetry window; only present when
    # the run had telemetry_windows > 0, and the cross series is
    # identically zero under the flat topology
    stats = getattr(result, "stats", None)
    if stats is not None and "tele" in stats:
        from repro_torch.obs.timeseries import Timeseries
        t = Timeseries.from_result(result)
        loc = t.counts("loc_msgs")
        xcl = t.counts("xcl_msgs")
        starts = t.window_start_cycle
        ev.append({"ph": "M", "pid": _PID_NOC, "name": "process_name",
                   "args": {"name": "noc"}})
        for i in range(t.n_used):
            ev.append({"ph": "C", "pid": _PID_NOC, "tid": 0,
                       "name": "link msgs", "ts": int(starts[i]),
                       "args": {"local": int(loc[i]),
                                "cross_cluster": int(xcl[i])}})
    return ev


def export(result: Any, path: str, include_work: bool = False,
           max_cores: Optional[int] = None) -> str:
    """Write ``result``'s event trace as Chrome-trace JSON to ``path``
    and return ``path``.  Load the file at https://ui.perfetto.dev.

    ``result`` must come from a ``record_trace=True`` run.  ``ts`` is in
    trace microseconds = simulated cycles.  ``include_work`` also
    renders the WORK (local compute) spans; ``max_cores`` limits the
    emitted core tracks for very wide machines.
    """
    doc = {"traceEvents": to_trace_events(result, include_work=include_work,
                                          max_cores=max_cores),
           "displayTimeUnit": "ms",
           "otherData": {"unit": "1 us = 1 simulated cycle"}}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
