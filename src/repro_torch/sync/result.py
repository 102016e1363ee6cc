"""``Result`` — the typed view of one simulation point (port).

The paper's metric triple and the latency percentiles are named
accessors, every raw counter stays reachable under :attr:`Result.stats`
(and via ``result["key"]``), and the benchmark-row / JSON serialization
matches the reference's ``repro.sync.Result``.  A ``Result`` always
carries the :class:`~repro_torch.sync.Spec` that produced it.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np

from repro_torch.core import metrics as _metrics
from repro_torch.core import workloads as _workloads
from repro_torch.sync.spec import Spec

#: scalar metrics serialized by ``to_json`` and carried by every row
_METRIC_KEYS = ("throughput", "jain_fairness", "energy_pj_per_op",
                "lat_p50", "lat_p95", "lat_max",
                "fairness_min", "fairness_max", "fairness_span")


def _scalar(v: Any) -> Any:
    """Plain-Python, JSON-safe scalar: numpy scalars unwrap, non-finite
    floats map to ``None`` (the starved-core ``fairness_span``)."""
    if isinstance(v, (np.generic, np.ndarray)):
        v = v.item()
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


@dataclasses.dataclass(frozen=True, eq=False)
class Result:
    """One simulation point: the producing :class:`Spec` plus the raw
    metric-annotated engine result dict (numpy) under :attr:`stats`."""
    spec: Spec
    stats: Mapping[str, Any] = dataclasses.field(repr=False)

    # ---- the paper's metric triple --------------------------------------
    @property
    def throughput(self) -> float:
        """Completed ops per cycle."""
        return float(self.stats["throughput"])

    @property
    def jain_fairness(self) -> float:
        """Jain's index over per-core completed ops (1.0 = uniform)."""
        return float(self.stats["jain_fairness"])

    @property
    def energy_pj_per_op(self) -> float:
        """pJ per completed op (Table II-calibrated event-energy model)."""
        return float(self.stats["energy_pj_per_op"])

    # ---- latency percentiles --------------------------------------------
    @property
    def lat_p50(self) -> float:
        return float(self.stats["lat_p50"])

    @property
    def lat_p95(self) -> float:
        return float(self.stats["lat_p95"])

    @property
    def lat_max(self) -> float:
        return float(self.stats["lat_max"])

    # ---- fairness family ------------------------------------------------
    @property
    def fairness_min(self) -> float:
        """Slowest core's ops/cycle."""
        return float(self.stats["fairness_min"])

    @property
    def fairness_max(self) -> float:
        """Fastest core's ops/cycle."""
        return float(self.stats["fairness_max"])

    @property
    def fairness_span(self) -> float:
        """Fastest/slowest ratio; ``inf`` once a core starves."""
        return float(self.stats["fairness_span"])

    # ---- counters -------------------------------------------------------
    @property
    def polls(self) -> int:
        """Failed attempts (retries) — 0 for polling-free protocols."""
        return int(np.asarray(self.stats["polls"]))

    @property
    def msgs(self) -> int:
        return int(np.asarray(self.stats["msgs"]))

    @property
    def ops_total(self) -> int:
        """Completed ops summed over cores."""
        return int(np.asarray(self.stats["ops"]).sum())

    @property
    def atomics_total(self) -> int:
        """Completed atomic accesses (micro-ops), summed over cores."""
        return int(np.asarray(self.stats["opc"]).sum())

    @property
    def atomics_per_cycle(self) -> float:
        return self.atomics_total / self.spec.costs.cycles

    @property
    def worker_rate(self) -> Optional[float]:
        """Fig. 5 streaming-worker service rate, or ``None`` when the
        spec has no workers."""
        v = self.stats.get("worker_rate")
        return None if v is None else float(v)

    # ---- sweep isolation ------------------------------------------------
    @property
    def ok(self) -> bool:
        """``False`` when this point is a sweep-isolation error record
        (its launch raised and the bisected retry failed too, or its
        metrics were non-finite)."""
        return "error" not in self.stats

    @property
    def error(self) -> Optional[str]:
        """The isolated failure (``"ExcType: message"``) or ``None``."""
        v = self.stats.get("error")
        return None if v is None else str(v)

    # ---- observability views --------------------------------------------
    def timeseries(self):
        """The windowed telemetry of this point as a typed
        :class:`repro_torch.obs.Timeseries`.  Requires the spec to have
        run with ``telemetry_windows > 0``; raises ``ValueError``
        otherwise."""
        from repro_torch.obs.timeseries import Timeseries
        return Timeseries.from_result(self)

    def events(self):
        """The event traces of this point as a typed
        :class:`repro_torch.obs.EventLog` (per-core state spans,
        retirement completions, per-bank queue-depth trace) — the input
        of ``repro_torch.obs.perfetto.export``.  Requires
        ``record_trace=True``; raises ``ValueError`` otherwise."""
        from repro_torch.obs.events import EventLog
        return EventLog.from_result(self)

    # ---- raw access -----------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self.stats[key]

    def __contains__(self, key: str) -> bool:
        return key in self.stats

    def get(self, key: str, default: Any = None) -> Any:
        return self.stats.get(key, default)

    def keys(self) -> Iterator[str]:
        return self.stats.keys()

    # ---- serialization --------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """The named scalar metrics as a plain JSON-safe dict."""
        out: Dict[str, Any] = {k: _scalar(self.stats[k])
                               for k in _METRIC_KEYS if k in self.stats}
        if "polls" in self.stats:
            out["polls"] = self.polls
        if "msgs" in self.stats:
            out["msgs"] = self.msgs
        if "ops" in self.stats:
            out["ops"] = self.ops_total
        if "opc" in self.stats:                  # raw engine result
            out["atomics"] = self.atomics_total
        elif "atomics" in self.stats:            # from_json round trip
            out["atomics"] = int(self.stats["atomics"])
        if self.worker_rate is not None:
            out["worker_rate"] = self.worker_rate
        if "error" in self.stats:
            out["error"] = str(self.stats["error"])
            if "error_stage" in self.stats:
                out["error_stage"] = str(self.stats["error_stage"])
        return out

    def to_row(self, **extra: Any) -> Dict[str, Any]:
        """One flat JSON-safe benchmark-report row: spec identifiers +
        the full metric set, with ``extra`` entries overriding."""
        row: Dict[str, Any] = {
            "protocol": self.spec.protocol.name,
            "workload": self.spec.workload.name,
            "topology": self.spec.topology.name,
            "cores": self.spec.topology.n_cores,
        }
        row.update(self.metrics())
        row.update(extra)
        return {k: _scalar(v) for k, v in row.items()}

    def to_json(self, **dumps_kw: Any) -> str:
        """Spec + named metrics as JSON; :meth:`from_json` restores a
        metrics-only ``Result``."""
        return json.dumps({"spec": self.spec.to_dict(),
                           "metrics": self.metrics()}, **dumps_kw)

    @classmethod
    def from_json(cls, s: str) -> "Result":
        d = json.loads(s)
        stats = {}
        for k, v in d["metrics"].items():
            if v is None:
                # ``fairness_span``'s None encodes inf (a starved core)
                if k == "fairness_span":
                    stats[k] = math.inf
                continue
            stats[k] = v
        return cls(spec=Spec.from_dict(d["spec"]), stats=stats)

    # ---- workload validation --------------------------------------------
    def check(self) -> Dict[str, Any]:
        """Run the producing workload's conservation-law validator, with
        the completion trace when the spec recorded one."""
        wl = _workloads.get(self.spec.workload.name)
        return wl.check(self.spec.to_params(), self.stats,
                        self.stats.get("trace_step"))

    def energy_stats(self) -> Dict[str, float]:
        """The billable stat totals (the costmodel input contract)."""
        return _metrics.energy_stats(self.stats)
