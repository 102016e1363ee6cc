"""``flat`` — the degenerate single-crossbar topology.

No levels: every (core, bank) pair is one hop at the baseline ``lat``,
and the only bandwidth limit is the global ``net_bw`` acceptance budget.
``tables()`` therefore compiles to ``is_flat=True`` and the engine runs
no topology stage at all.
"""
from __future__ import annotations

from repro_torch.core.topologies.base import Topology
from repro_torch.core.topologies.registry import register


@register
class Flat(Topology):
    name = "flat"
    levels = ()
