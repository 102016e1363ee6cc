"""Trace-safety checks that need no framework: the port's result keys
and kernel instances.

The reference audits its jaxprs (one scan, the budgeted carries, the
hot scatter count).  The port has no jaxpr: its engine is an eager loop
on the CPU and one launch of a kernel instance on the card.  What the
reference's audit protects — optional features change nothing when
they are off, and a knob that reshapes the computation is a static
sweep axis — is checked here on the port's own subjects, under the
reference's rule names:

* ``carry-count`` — ``simulate``'s result keys, on the CPU at a small
  size, are exactly a budget built from parts: the engine's base keys
  (:data:`ENGINE_KEYS`), the protocol's bank and core state, and the
  feature deltas the reference budgets (+1 telemetry, +3 faults, +2
  holder kill, +3 watchdog, +1 hierarchical topology) plus the event
  traces' 4 and a fault run's dead-core mask (and ``recoveries``, 0,
  without a watchdog).  The empty ``FaultPlan`` adds no key.
* ``backend-parity`` — ``launch_variant`` puts a run with every feature
  off on the narrow instance (the wide one for ``WIDE_FAMILIES``), never
  on the program, topology or fault instance, and each feature's run on
  its own instance; and the card path's result views (``pack_runs``,
  laid out on the CPU) have the plain loop's keys, dtypes and shapes.
* ``static-knob`` — every ``SimParams`` field that changes a launch's
  grouping, its kernel instance or its result keys is in
  ``core/sweep.py::STATIC_FIELDS``: each field is changed from a base
  point and the three are observed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.report import Finding, PassReport
from repro_torch.core import protocols as proto_registry
from repro_torch.core import sim, sweep
from repro_torch.core import topologies as topo_registry
from repro_torch.core import workloads as wl_registry
from repro_torch.core.workloads.base import K_BARRIER
from repro_torch.faults import FaultPlan
from repro_torch.kernels.engine_step import kernel as es_kernel

#: the keys of ``simulate``'s result on EVERY run, before protocol state
#: and feature deltas (the reference's 27 engine carries)
ENGINE_KEYS: Tuple[str, ...] = (
    "st", "tmr", "addr", "phase", "pc", "bar_cnt", "nxt", "arr_cyc",
    "parked", "resp_prev", "opc", "streak", "ops", "acq_start",
    "msgs", "polls", "addr_ops", "sleep_cyc", "bar_cyc", "lat_hist",
    "lat_max", "backoff_cyc", "active_cyc", "bank_ops", "net_stall",
    "w_tmr", "w_served")

#: feature deltas (keys a switched-on feature adds), as the reference
#: budgets them
TELEMETRY_KEYS = ("tele",)
FAULTS_KEYS = ("faults_injected", "halt_cyc", "last_ret")
HOLDER_KILL_KEYS = ("kmask", "kleft")
WATCHDOG_KEYS = ("wd_srv", "wd_own", "recoveries")
TOPO_KEYS = ("hops",)
#: the per-cycle traces of ``record_trace`` (the reference's 4 ys)
TRACE_KEYS = ("trace_step", "trace_wait", "trace_state", "trace_qlen")
#: a fault run's result beyond its carried state: the cores dead at the
#: horizon (``recoveries``, 0, stands in for a missing watchdog's)
FAULT_RESULT_KEYS = ("dead_mask",)

#: the CPU runs' size (small: the plain loop takes ~1 ms a cycle here)
_BASE = dict(n_cores=8, cycles=24, n_addrs=2)


def reference_params(name: str, **kw: Any) -> sim.SimParams:
    """The checks' reference config: small, every optional feature off
    (overridable via ``kw``)."""
    return sim.SimParams(**dict(_BASE, protocol=name, **kw))


def _variants(name: str) -> List[Tuple[str, sim.SimParams]]:
    return [
        ("base", reference_params(name)),
        ("telemetry", reference_params(name, telemetry_windows=4)),
        ("trace", reference_params(name, record_trace=True)),
        ("kill", reference_params(
            name, faults=FaultPlan(n_kill=1, kill_cyc=4))),
        ("kill+wd", reference_params(
            name, faults=FaultPlan(n_kill=1, kill_cyc=4, watchdog_cyc=8))),
        ("cluster2", reference_params(name, topology="cluster2",
                                      clusters=2)),
    ]


def expected_keys(p: sim.SimParams) -> List[str]:
    """The result keys budgeted for ``p``, from the engine's base keys,
    the protocol's declared state and the feature gates — computed
    without running the engine, so a drift between this and the real
    result is always a reportable finding."""
    proto = proto_registry.get(p.protocol)
    n, a = p.n_cores, p.n_addrs
    bank = proto.init_bank_state(p, a, n, proto.q_cap(p, n), "cpu")
    keys = list(ENGINE_KEYS) + list(bank) \
        + list(proto.init_core_state(p, n, "cpu"))
    if p.telemetry_windows > 0:
        keys += TELEMETRY_KEYS
    if topo_registry.get(p.topology).levels:
        keys += TOPO_KEYS
    fp = p.faults
    if fp.enabled:
        keys += FAULTS_KEYS + FAULT_RESULT_KEYS
        if fp.n_kill > 0 and fp.kill_holder == 1:
            keys += HOLDER_KILL_KEYS
        if fp.watchdog_cyc > 0 and proto.held(bank) is not None:
            keys += WATCHDOG_KEYS
        else:
            keys.append("recoveries")
    if p.record_trace:
        keys += TRACE_KEYS
    return keys


def _variant(p: sim.SimParams) -> int:
    """The run kernel's instance for a launch of ``p`` alone."""
    return es_kernel.launch_variant([es_kernel.run_scalars(
        p, proto_registry.get(p.protocol),
        wl_registry.get(p.workload).program(p))])


def _signature(p: sim.SimParams) -> tuple:
    """What a field may change: the launch group, the kernel instance and
    the CPU run's result keys."""
    return (sweep._launch_key(p), _variant(p),
            tuple(sim._simulate_plain(p, "cpu")))


def _expected_variant(p: sim.SimParams) -> int:
    proto = proto_registry.get(p.protocol)
    prog = wl_registry.get(p.workload).program(p)
    if p.faults.enabled:
        return es_kernel.INSTANCE_FAULT
    if topo_registry.get(p.topology).levels:
        return es_kernel.INSTANCE_TOPO
    if prog.length > 1 or K_BARRIER in prog.kind:
        return es_kernel.INSTANCE_PROG
    if proto.kernel_code in es_kernel.WIDE_FAMILIES:
        return es_kernel.INSTANCE_WIDE
    return es_kernel.INSTANCE_NARROW


def _views(p: sim.SimParams) -> Dict[str, tuple]:
    """The card path's result of ``p``: (dtype, shape) of each view
    ``pack_runs`` lays out (on the CPU; no kernel runs)."""
    proto = proto_registry.get(p.protocol)
    sc = es_kernel.run_scalars(p, proto,
                               wl_registry.get(p.workload).program(p))
    out = es_kernel.pack_runs([(p, proto, sc)], "cpu",
                              lambda n, a: 0)["outs"][0]
    return {k: (v.dtype, tuple(v.shape)) for k, v in out.items()
            if k != "scalars"}


def audit_protocol(name: str, quick: bool = False) -> PassReport:
    """The result-key budget across the feature variants, and backend
    parity, of one protocol."""
    rep = PassReport(pass_name="trace", subject=name)
    t0 = time.perf_counter()
    keys: Dict[str, int] = {}
    for label, p in _variants(name)[:1 if quick else None]:
        res = sim._simulate_plain(p, "cpu")
        want = expected_keys(p)
        keys[label] = len(res)
        if sorted(res) != sorted(want) or len(want) != len(set(want)):
            extra = sorted(set(res) - set(want))
            missing = sorted(set(want) - set(res))
            rep.findings.append(Finding(
                "trace", "carry-count", name,
                f"result keys {len(res)} != budget {len(want)} (engine "
                f"{len(ENGINE_KEYS)} + protocol state + feature deltas); "
                f"unbudgeted {extra}, missing {missing}", where=label))
        got = _variant(p)
        if got != _expected_variant(p):
            rep.findings.append(Finding(
                "trace", "backend-parity", name,
                f"launch_variant picks instance {got}, expected "
                f"{_expected_variant(p)}", where=label))
        views = _views(p)
        plain = {k: (v.dtype, tuple(v.shape)) for k, v in res.items()}
        if views != plain:
            bad = sorted(k for k in set(views) | set(plain)
                         if views.get(k) != plain.get(k))
            rep.findings.append(Finding(
                "trace", "backend-parity", name,
                f"the card path's result views differ from the plain "
                f"loop's for {bad}", where=label))
    rep.stats["result_keys"] = keys
    rep.wall_s = time.perf_counter() - t0
    return rep


#: a changed value per SimParams field (the base point is
#: ``reference_params("colibri")``); every field must have one
FIELD_CHANGES: Dict[str, Any] = dict(
    protocol="colibri_hier", workload="ms_queue", n_cores=16, unroll=2,
    backend="auto",                  # the one value the port accepts
    n_addrs=3, cycles=30, lat=3, work=7, modify=2,
    backoff=64, backoff_exp=3, q_slots=4, net_bw=5, hol_block=2,
    n_workers=2, seed=9, n_groups=2, zipf_skew=150, topology="cluster2",
    clusters=2, record_trace=True, telemetry_windows=4,
    faults=FaultPlan(n_kill=1, kill_cyc=4, watchdog_cyc=8))


def audit_static_fields() -> PassReport:
    """Each ``SimParams`` field changed from the base point: a field that
    changes the launch group, the kernel instance or the result keys must
    be a static sweep axis (a dynamic one would put runs of different
    instances or result layouts in one launch)."""
    rep = PassReport(pass_name="trace", subject="sweep.STATIC_FIELDS")
    t0 = time.perf_counter()
    base = reference_params("colibri")
    sig0 = _signature(base)
    affecting = []
    for f in dataclasses.fields(sim.SimParams):
        if f.name not in FIELD_CHANGES:
            rep.findings.append(Finding(
                "trace", "static-knob", "sweep.STATIC_FIELDS",
                f"SimParams field {f.name!r} has no changed value to "
                f"observe"))
            continue
        p = dataclasses.replace(base, **{f.name: FIELD_CHANGES[f.name]})
        if _signature(p) != sig0:
            affecting.append(f.name)
    missing = [f for f in affecting if f not in sweep.STATIC_FIELDS]
    if missing:
        rep.findings.append(Finding(
            "trace", "static-knob", "sweep.STATIC_FIELDS",
            f"SimParams fields {missing} change a launch's grouping, "
            f"kernel instance or result keys but are not declared static "
            f"sweep axes"))
    rep.stats.update(static_fields=list(sweep.STATIC_FIELDS),
                     affecting=affecting)
    rep.wall_s = time.perf_counter() - t0
    return rep


def check_all(quick: bool = False,
              protocols: Optional[List[str]] = None) -> List[PassReport]:
    names = protocols or proto_registry.names()
    reps = [audit_protocol(nm, quick=quick) for nm in names]
    reps.append(audit_static_fields())
    return reps
