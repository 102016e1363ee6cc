"""NoC topology plugins for the cycle-level engine (port).

Importing this package registers the topologies the port covers so far:

=============  ==========================================================
``flat``       single crossbar (the engine's historical shape); compiles
               to no tables at all
=============  ==========================================================

The reference's hierarchical ``cluster2``/``cluster3`` are not ported
yet; asking for one fails at ``SimParams`` construction.
"""
from repro_torch.core.topologies import flat
from repro_torch.core.topologies.base import LinkLevel, TopoTables, Topology
from repro_torch.core.topologies.registry import get, names, register

__all__ = ["LinkLevel", "TopoTables", "Topology", "get", "names",
           "register", "flat"]
