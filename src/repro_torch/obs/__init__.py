"""``repro_torch.obs`` — the observability views of the port.

Two layers over the cycle-level engine, each answering a question the
end-of-run aggregates cannot:

* **windowed telemetry** (:class:`Timeseries`, ``repro_torch.obs.schema``)
  — what was the machine doing *over time*?  The ``telemetry_windows``
  Spec knob makes the engine accumulate a ``(n_windows, TELE_K)``
  timeseries (core-state counts, queue depths, grant/fail/sleep/wake
  outcomes, NoC traffic); ``Result.timeseries()`` returns the typed view.
* **event traces** (:class:`EventLog`, :mod:`repro_torch.obs.perfetto`)
  — what did core 17 do at cycle 1402?  ``record_trace=True`` runs carry
  per-cycle state and queue-depth traces; ``Result.events()`` gives the
  span/completion view and :func:`perfetto.export` writes a Chrome trace
  JSON loadable at https://ui.perfetto.dev.
* **runner instrumentation** (:class:`RunReport`, :func:`collect`) —
  where a sweep's time goes: one record per launched chunk (library
  build or load, the card's time to the end of the chunk's host copy),
  collected explicitly or ambiently with ``with obs.collect() as
  report:``.

Submodules import lazily (PEP 562), so the engine's dependency on
``repro_torch.obs.schema`` stays one light leaf module.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

__all__ = ["schema", "Timeseries", "EventLog", "Span", "RunReport",
           "ChunkRecord", "collect", "current", "perfetto"]

if TYPE_CHECKING:                     # pragma: no cover - typing only
    from repro_torch.obs import perfetto, schema
    from repro_torch.obs.events import EventLog, Span
    from repro_torch.obs.runreport import (ChunkRecord, RunReport, collect,
                                           current)
    from repro_torch.obs.timeseries import Timeseries

#: attribute -> (submodule, member or None for the module itself)
_LAZY = {
    "schema": ("repro_torch.obs.schema", None),
    "perfetto": ("repro_torch.obs.perfetto", None),
    "Timeseries": ("repro_torch.obs.timeseries", "Timeseries"),
    "EventLog": ("repro_torch.obs.events", "EventLog"),
    "Span": ("repro_torch.obs.events", "Span"),
    "RunReport": ("repro_torch.obs.runreport", "RunReport"),
    "ChunkRecord": ("repro_torch.obs.runreport", "ChunkRecord"),
    "collect": ("repro_torch.obs.runreport", "collect"),
    "current": ("repro_torch.obs.runreport", "current"),
}


def __getattr__(name: str):
    try:
        modname, member = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                             f"{name!r}") from None
    import importlib
    mod = importlib.import_module(modname)
    value = mod if member is None else getattr(mod, member)
    globals()[name] = value           # cache for subsequent lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
