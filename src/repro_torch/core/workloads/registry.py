"""String-keyed registry of workload plugins — the algorithm twin of
``protocols.registry``.

Adding a workload is one module: subclass ``base.Workload``, decorate
the class (or call ``register`` on an instance), import it from
``workloads/__init__``.  The engine, sweep runner, and benchmarks all
resolve workloads by name through ``get``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.workloads.base import Workload

_REGISTRY: Dict[str, Workload] = {}


def register(wl):
    """Register a Workload subclass or instance under its ``name``."""
    inst = wl() if isinstance(wl, type) else wl
    if not inst.name:
        raise ValueError(f"workload {wl!r} has no name")
    if inst.name in _REGISTRY:
        raise ValueError(f"duplicate workload name: {inst.name}")
    _REGISTRY[inst.name] = inst
    return wl


def get(name: str) -> Workload:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown workload {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
