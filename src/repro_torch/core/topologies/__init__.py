"""NoC topology plugins for the cycle-level engine (port).

Importing this package registers every topology the reference has:

=============  ==========================================================
``flat``       single crossbar (the engine's historical shape); compiles
               to no tables at all
``cluster2``   two-level hierarchical-cluster NoC (+8 cyc / bw÷4
               cross-cluster)
``cluster3``   three-level variant: cluster (+6 / ÷2) below a top-level
               group boundary (+12 / ÷8)
=============  ==========================================================

A topology compiles ``(p, n_cores, n_addrs)`` into per-(core, bank) hop,
latency and level-crossing tables that the plain loop's network stage
gathers from; the engine kernel derives the same values from the default
placement (``Topology.uses_default_tree``) and refuses any other.
"""
from repro_torch.core.topologies import cluster, flat
from repro_torch.core.topologies.base import LinkLevel, TopoTables, Topology
from repro_torch.core.topologies.registry import get, names, register

__all__ = ["LinkLevel", "TopoTables", "Topology", "get", "names",
           "register", "cluster", "flat"]
