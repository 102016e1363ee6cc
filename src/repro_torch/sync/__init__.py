"""``repro_torch.sync`` — the public API of the PyTorch port.

The same nouns as the reference's ``repro.sync``:

* :class:`Spec` — a frozen, validated description of one simulation
  point (the reference's groups, fields and JSON).
* :class:`Result` — the typed result of one point.
* :class:`Study` — a declarative multi-point experiment
  (``Study(base).grid(lat=[1, 4, 16]).zip(seed=range(4))``) run through
  the batched sweep: on the GPU the points of one core count are one
  launch of the engine kernel, a grid of run blocks.

Quickstart (on a machine with an NVIDIA GPU)::

    from repro_torch.sync import Spec, run

    r = run(Spec(protocol="colibri", workload="zipf_histogram",
                 n_addrs=1, zipf_skew=0))
    print(r.throughput, r.jain_fairness, r.energy_pj_per_op, r.polls)

``run`` computes on the GPU unless the caller asks for the CPU with
``device="cpu"``; without a visible GPU and without that request it
raises.  Results are bit-identical to ``repro.sync.run`` for every point
the port covers, and ``Study(...).run()`` to the reference's ``Study``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.core import protocols as _protocols
from repro_torch.core import sim as _sim
from repro_torch.core import workloads as _workloads
from repro_torch.core.metrics import METRIC_TRIPLE
from repro_torch.core.sweep import enable_persistent_cache
from repro_torch.sync.result import Result
from repro_torch.sync.spec import Costs, Protocol, Spec, Topology, Workload
from repro_torch.sync.study import Study

__all__ = ["Spec", "Result", "Study", "run",
           "Protocol", "Workload", "Topology", "Costs",
           "protocols", "workloads", "scenario", "METRIC_TRIPLE",
           "enable_persistent_cache"]


def run(spec: Optional[Spec] = None, *, device=None, energy_fit=None,
        **flat: Any) -> Result:
    """Run ONE simulation point and return its typed :class:`Result`.

    Accepts a :class:`Spec` (or spec dict), or flat Spec fields
    directly: ``run(protocol="colibri", n_addrs=1)``.  ``device`` is
    where the engine runs: ``None`` means ``"cuda"`` (and raises when no
    GPU is visible); pass ``"cpu"`` to run on the CPU.  ``energy_fit``
    overrides the frozen Table II calibration behind
    ``energy_pj_per_op``.
    """
    if spec is None:
        spec = Spec(**flat)
    else:
        if isinstance(spec, dict):
            spec = Spec.from_dict(spec)
        if flat:
            spec = spec.replace(**flat)
    return Result(spec=spec,
                  stats=_sim.execute(spec.to_params(), energy_fit=energy_fit,
                                     device=device))


def protocols() -> Tuple[str, ...]:
    """Names of every registered synchronization protocol."""
    return _protocols.names()


def workloads() -> Tuple[str, ...]:
    """Names of every registered concurrent-algorithm workload."""
    return _workloads.names()


def scenario(workload: str) -> dict:
    """A workload's canonical Spec overrides (hot-word count, skew, ...)."""
    return dict(_workloads.get(workload).scenario)
