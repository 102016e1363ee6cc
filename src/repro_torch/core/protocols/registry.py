"""String-keyed registry of synchronization protocol plugins.

Adding a protocol is one module: subclass ``base.Protocol``, decorate the
class (or call ``register`` on an instance), import it from
``protocols/__init__``.  The engine resolves protocols by name through
``get``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.protocols.base import Protocol

_REGISTRY: Dict[str, Protocol] = {}


def register(proto):
    """Register a Protocol subclass or instance under its ``name``."""
    inst = proto() if isinstance(proto, type) else proto
    if not inst.name:
        raise ValueError(f"protocol {proto!r} has no name")
    if inst.name in _REGISTRY:
        raise ValueError(f"duplicate protocol name: {inst.name}")
    _REGISTRY[inst.name] = inst
    return proto


def get(name: str) -> Protocol:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown protocol {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
