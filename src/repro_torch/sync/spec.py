"""``Spec`` — the frozen, validated, declarative simulation spec (port).

The same groups, fields, defaults and JSON as the reference's
``repro.sync.Spec``: a spec written by either package loads in the other.

A :class:`Spec` is the public description of ONE simulation point,
organised into five sub-groups instead of the engine's flat
``SimParams``:

=============  ==========================================================
``protocol``   which synchronization protocol owns the banks, plus its
               policy knobs (queue capacity, cluster count, backoff)
``workload``   which concurrent-algorithm program each core runs, plus
               its knobs (Zipf skew, Fig. 5 streaming-worker count)
``topology``   the machine: cores, contended addresses/banks, network
               bandwidth, head-of-line blocking factor
``costs``      cycle costs and execution: network latency, local work,
               modify time, horizon, seed, the event-trace and telemetry
               switches, and the reference's unroll and backend (kept
               for JSON compatibility)
``faults``     fault injection & recovery (:class:`repro_torch.faults.
               FaultPlan`): core kills/stalls, message drops, bank
               stalls, the reservation watchdog and the forward-
               progress detector; all-zero = off
=============  ==========================================================

Construction is deliberately forgiving about *shape* and strict about
*content*:

* flat kwargs — ``Spec(protocol="lrsc", n_cores=64, lat=3)`` routes
  each field to its group automatically;
* per-group dicts — ``Spec(protocol={"name": "lrscwait", "q_slots": 8})``
  (unnamed fields keep their defaults);
* plain dicts / JSON — :meth:`Spec.from_dict` / :meth:`Spec.from_json`
  accept either shape (and round-trip :meth:`to_dict` / :meth:`to_json`);
* group instances — ``Spec(topology=Topology(n_cores=1024))``.

Every constructor path validates at construction time: an unknown
protocol/workload name raises a ``ValueError`` listing the registry's
available names, and impossible field values (``n_cores <= 0``,
``cycles <= 0``, ``n_addrs`` below the workload's minimum, ...) raise
immediately.  Validation lives in ONE place
(``SimParams.__post_init__``): a ``Spec`` lowers onto the engine's
``SimParams`` via :meth:`to_params`, and constructing that
``SimParams`` eagerly at ``Spec`` construction is what validates it.

Specs are frozen, hashable and equality-comparable, so they work as
dict keys.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping

from repro_torch.core.sim import SimParams
from repro_torch.faults import FaultPlan


@dataclasses.dataclass(frozen=True)
class Protocol:
    """Synchronization protocol choice + policy knobs."""
    name: str = "colibri"
    q_slots: int = 256        # lrscwait queue capacity (>= n_cores = ideal)
    n_groups: int = 4         # colibri_hier: clusters of cores
    backoff: int = 160        # retry backoff base (paper: fixed 128)
    backoff_exp: int = 2      # exponential doublings cap (1 = fixed)


@dataclasses.dataclass(frozen=True)
class Workload:
    """Concurrent-algorithm program choice + its knobs."""
    name: str = "rmw_loop"
    zipf_skew: int = 100      # 100*s for ADDR_ZIPF streams (s = 1.0)
    n_workers: int = 0        # Fig. 5: cores streaming a matmul instead


@dataclasses.dataclass(frozen=True)
class Topology:
    """The simulated machine: size, NoC shape, and network knobs."""
    name: str = "flat"        # NoC topology (core.topologies registry):
    #                           flat single crossbar, or hierarchical
    #                           cluster2/cluster3 with per-level extra
    #                           latency and cross-cluster link budgets
    n_cores: int = 256
    n_addrs: int = 1          # contended addresses (fewer = hotter)
    net_bw: int = 64          # network acceptances per cycle
    hol_block: int = 16       # parked reqs per occupied net slot (0 = off)
    clusters: int = 4         # leaf clusters (hierarchical topologies)


@dataclasses.dataclass(frozen=True)
class Costs:
    """Cycle costs and execution knobs."""
    lat: int = 5              # one-way network latency (cycles)
    work: int = 10            # local work between atomics
    modify: int = 4           # cycles between load and store
    cycles: int = 20_000      # simulated horizon
    seed: int = 0
    unroll: int = 1           # the reference's scan unroll; no effect
    backend: str = "auto"     # only "auto": the run's device picks the
    #                           CUDA kernel or its plain version
    record_trace: bool = False  # per-cycle event traces (Result.events())
    telemetry_windows: int = 0  # windowed telemetry (Result.timeseries())


#: Certified field envelope for the static analyses
#: (``repro_torch.analysis``): inclusive (lo, hi) bounds per Spec field,
#: the reference's ``repro.sync.spec.ANALYSIS_BOUNDS``.  The integer-range
#: pass proves the port's integer arithmetic safe over every Spec inside
#: it (lower bounds mirror ``SimParams._BOUNDS``; upper bounds are the
#: certification scale).  A Spec outside the envelope still runs; it is
#: just not covered by the certificate.
ANALYSIS_BOUNDS: Dict[str, tuple] = {
    "n_cores": (1, 16_384),
    "cycles": (1, 2**31 - 1),
    "n_addrs": (1, 16_384),
    "lat": (0, 2**16),
    "work": (0, 2**16),
    "modify": (0, 2**16),
    "backoff": (0, 2**20),
    "backoff_exp": (1, 8),
    "q_slots": (1, 16_384),
    "net_bw": (1, 2**20),
    "hol_block": (0, 2**20),
    "n_workers": (0, 16_384),
    "n_groups": (1, 16_384),
    "zipf_skew": (0, 10_000),
    "telemetry_windows": (0, 2**16),
    "unroll": (1, 64),
    "clusters": (1, 4_096),
}

#: (spec attribute, group class) in declaration order.  ``faults`` is
#: special in ONE way: it lowers onto a single ``SimParams.faults``
#: field instead of being flattened (see ``_lower``).
_GROUPS = (("protocol", Protocol), ("workload", Workload),
           ("topology", Topology), ("costs", Costs),
           ("faults", FaultPlan))

#: flat field name -> owning group attribute ("protocol"/"workload"
#: route to the group's ``name``; every other field name is unique)
_FLAT_TO_GROUP: Dict[str, str] = {}
for _gname, _gcls in _GROUPS:
    for _f in dataclasses.fields(_gcls):
        if _f.name != "name":
            _FLAT_TO_GROUP[_f.name] = _gname


def _build_group(gname: str, gcls, value, flat: Dict[str, Any]):
    """One group instance from (group value or None) + routed flat kwargs."""
    if isinstance(value, gcls):
        base = dataclasses.asdict(value)
    elif isinstance(value, str) and gname in ("protocol", "workload",
                                              "topology"):
        base = {"name": value}
    elif isinstance(value, Mapping):
        base = dict(value)
    elif value is None:
        base = {}
    else:
        raise ValueError(
            f"Spec {gname} must be a {gcls.__name__}, a dict"
            + (", a name string" if gname in ("protocol", "workload",
                                              "topology")
               else "") + f" or None (got {value!r})")
    known = {f.name for f in dataclasses.fields(gcls)}
    unknown = set(base) - known
    if unknown:
        raise ValueError(
            f"unknown {gname} field(s) {sorted(unknown)}; "
            f"{gcls.__name__} fields: {sorted(known)}")
    base.update(flat)
    return gcls(**base)


@dataclasses.dataclass(frozen=True, init=False)
class Spec:
    """One frozen, validated simulation point.  See the module docstring
    for the accepted construction shapes."""
    protocol: Protocol
    workload: Workload
    topology: Topology
    costs: Costs
    faults: FaultPlan

    def __init__(self, protocol=None, workload=None, topology=None,
                 costs=None, faults=None, **flat: Any):
        routed: Dict[str, Dict[str, Any]] = {g: {} for g, _ in _GROUPS}
        for k, v in flat.items():
            g = _FLAT_TO_GROUP.get(k)
            if g is None:
                raise ValueError(
                    f"unknown Spec field {k!r}; known fields: "
                    f"{', '.join(sorted(_FLAT_TO_GROUP))} (plus the "
                    f"groups protocol/workload/topology/costs/faults)")
            routed[g][k] = v
        given = {"protocol": protocol, "workload": workload,
                 "topology": topology, "costs": costs, "faults": faults}
        for gname, gcls in _GROUPS:
            object.__setattr__(self, gname, _build_group(
                gname, gcls, given[gname], routed[gname]))
        # eager lowering doubles as validation: SimParams.__post_init__
        # owns every name/bound check, so Spec and the legacy surface
        # can never drift apart on what is legal
        object.__setattr__(self, "_params", self._lower())

    # ---- lowering -------------------------------------------------------
    def _lower(self) -> SimParams:
        kw: Dict[str, Any] = {"protocol": self.protocol.name,
                              "workload": self.workload.name,
                              "topology": self.topology.name,
                              "faults": self.faults}
        for gname, gcls in _GROUPS:
            if gname == "faults":          # one engine field, not flattened
                continue
            g = getattr(self, gname)
            for f in dataclasses.fields(gcls):
                if f.name != "name":
                    kw[f.name] = getattr(g, f.name)
        return SimParams(**kw)

    def to_params(self) -> SimParams:
        """The engine-level ``SimParams`` this spec lowers to."""
        return self._params

    @classmethod
    def from_params(cls, p: SimParams) -> "Spec":
        """Lift an engine-level ``SimParams`` into a ``Spec``."""
        kw = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
        return cls(**kw)

    # ---- dict / JSON ----------------------------------------------------
    def to_dict(self) -> Dict[str, Dict[str, Any]]:
        """Nested plain dict (one sub-dict per group); JSON-ready and
        accepted back by :meth:`from_dict`."""
        return {g: dataclasses.asdict(getattr(self, g)) for g, _ in _GROUPS}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Spec":
        """Build from a plain dict — nested (group sub-dicts), flat
        (engine field names), or any mix."""
        return cls(**dict(d))

    def to_json(self, **dumps_kw: Any) -> str:
        return json.dumps(self.to_dict(), **dumps_kw)

    @classmethod
    def from_json(cls, s: str) -> "Spec":
        return cls.from_dict(json.loads(s))

    # ---- derivation -----------------------------------------------------
    def replace(self, **changes: Any) -> "Spec":
        """A new ``Spec`` with ``changes`` applied: flat field names,
        ``protocol=``/``workload=`` name strings, or *partial* group
        dicts (``topology={"n_cores": 1024}`` keeps the other topology
        fields).  Validates like any construction."""
        merged = self.to_dict()
        # group-level changes first, flat fields second, so a flat field
        # always lands on top of a whole-group replacement regardless of
        # the kwarg order (replace(seed=5, costs=Costs(...)) keeps seed=5)
        for k, v in changes.items():
            if k not in merged:
                continue
            if isinstance(v, str) and k in ("protocol", "workload",
                                            "topology"):
                merged[k]["name"] = v
            elif isinstance(v, Mapping):
                merged[k].update(v)
            elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                merged[k] = dataclasses.asdict(v)
            else:
                merged[k] = v            # invalid; _build_group reports it
        for k, v in changes.items():
            if k in merged:
                continue
            g = _FLAT_TO_GROUP.get(k)
            if g is None:
                raise ValueError(
                    f"unknown Spec field {k!r}; known fields: "
                    f"{', '.join(sorted(_FLAT_TO_GROUP))}")
            merged[g][k] = v
        return Spec(**merged)
