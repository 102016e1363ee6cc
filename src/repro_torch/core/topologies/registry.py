"""String-keyed registry of NoC topology plugins.

Adding a topology is one module: subclass ``base.Topology``, decorate
the class (or call ``register`` on an instance), import it from
``topologies/__init__``.  The engine, sweep runner, and benchmarks all
resolve topologies by name through ``get``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.topologies.base import Topology

_REGISTRY: Dict[str, Topology] = {}


def register(topo):
    """Register a Topology subclass or instance under its ``name``."""
    inst = topo() if isinstance(topo, type) else topo
    if not inst.name:
        raise ValueError(f"topology {topo!r} has no name")
    if inst.name in _REGISTRY:
        raise ValueError(f"duplicate topology name: {inst.name}")
    _REGISTRY[inst.name] = inst
    return topo


def get(name: str) -> Topology:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown topology {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
