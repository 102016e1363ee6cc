"""Topology plugin interface: the machine's NoC shape as data.

The engine (``core.sim``) models a flat core↔bank crossbar; the paper's
Colibri is explicitly hierarchical (per-cluster reservation stations,
cross-cluster handoffs), and the related 1024-core manycore
(arXiv:2307.10248) routes every remote access through a multi-level
cluster NoC with per-level latencies and per-level link bandwidth.  A
:class:`Topology` plugin describes that shape declaratively — a cluster
tree with per-level extra latency and link capacity, plus a placement
rule mapping cores and banks onto clusters — and *compiles* it into
static per-(core, bank) tables the engine's network stage consumes:

* ``hops[c, b]``   — NoC hop count of a ``c → b`` request (1 for a
  bank in the core's own cluster, +2 per crossed level: up through the
  level router and back down);
* ``extra[c, b]``  — round-trip extra latency in cycles beyond the flat
  ``lat`` baseline, billed once at request issue;
* ``cross[ℓ][c, b]`` — whether a ``c → b`` message crosses level ``ℓ``'s
  boundary; crossing messages contend for that level's per-cycle link
  budget (``net_bw // bw_div``) on top of the global acceptance budget.

The tables are plain numpy, computed once per run.  The ``flat``
topology compiles to the *absence* of tables (:attr:`TopoTables.is_flat`),
so the engine gates every topology branch off in Python.  The engine
kernel takes no table: for a topology on the default tree
(:meth:`Topology.uses_default_tree`) it derives them from a core's and a
bank's leaf cluster and the level words.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinkLevel:
    """One boundary level of the cluster tree, leaf-most first."""
    name: str            # e.g. "cluster", "group"
    extra_lat: int       # round-trip extra cycles for crossing messages
    bw_div: int          # level link budget = max(1, net_bw // bw_div)

    def __post_init__(self):
        if self.extra_lat < 0:
            raise ValueError(f"level {self.name!r}: extra_lat must be >= 0")
        if self.bw_div < 1:
            raise ValueError(f"level {self.name!r}: bw_div must be >= 1")


@dataclasses.dataclass(frozen=True)
class TopoTables:
    """Compiled per-(core, bank) tables for one (topology, n, a, clusters)
    point.  All arrays are numpy (trace-time constants)."""
    hops: np.ndarray                      # (n, a) int32, >= 1
    extra: np.ndarray                     # (n, a) int32, >= 0
    cross: Tuple[np.ndarray, ...]         # per level: (n, a) bool
    core_cluster: np.ndarray              # (n,) int32 leaf-cluster of core
    bank_cluster: np.ndarray              # (a,) int32 leaf-cluster of bank
    is_flat: bool                         # no levels: engine gates all off


class Topology:
    """Base topology plugin.  Subclasses declare ``name`` and ``levels``
    and may override the placement hooks."""

    name: str = ""
    #: boundary levels, leaf-most first (empty = flat crossbar)
    levels: Tuple[LinkLevel, ...] = ()

    # ---- placement ------------------------------------------------------
    def leaf_geometry(self, p, n: int, a: int) -> Tuple[int, int, int]:
        """``(core_size, core_clusters, bank_clusters)`` of ``n`` cores
        and ``a`` banks: core ``i``'s leaf cluster is
        ``min(i // core_size, core_clusters - 1)`` (a contiguous block
        placement whose remainder joins the last cluster, the hw_event
        protocol's group geometry, so the event unit a core registers
        with is the cluster the topology routes it to), bank ``b``'s is
        ``b % bank_clusters``.  The one statement of the rule: the
        placement hooks apply it, and the engine kernel takes these three
        words."""
        clusters = getattr(p, "clusters", 1)
        core_clusters = max(1, min(clusters, n))
        return (max(1, n // core_clusters), core_clusters,
                max(1, min(clusters, max(a, 1))))

    def core_clusters(self, p, n: int) -> np.ndarray:
        """(n,) leaf-cluster id of every core (block placement)."""
        size, count, _ = self.leaf_geometry(p, n, 0)
        return np.minimum(np.arange(n) // size, count - 1).astype(np.int32)

    def bank_clusters(self, p, a: int) -> np.ndarray:
        """(a,) leaf-cluster id of every bank.  Banks interleave across
        clusters (``b % clusters``) — the address-interleaved SPM layout
        of the reference manycore, so hot addresses spread over all
        cluster-local memories instead of piling into one."""
        _, _, count = self.leaf_geometry(p, 0, a)
        return (np.arange(a) % count).astype(np.int32)

    def level_cluster(self, leaf: np.ndarray, level: int, p) -> np.ndarray:
        """Collapse leaf-cluster ids to the cluster id at ``level`` (0 =
        leaf).  Default tree: each level pairs up the clusters below it
        (``leaf >> level``)."""
        return leaf >> level

    def uses_default_tree(self) -> bool:
        """Whether this topology keeps the base placement hooks (the
        placement of :meth:`leaf_geometry`, the ``leaf >> level`` tree):
        the engine kernel derives its tables from that rule and refuses a
        topology that overrides them."""
        base = Topology
        return all(getattr(type(self), f) is getattr(base, f)
                   for f in ("core_clusters", "bank_clusters",
                             "level_cluster", "tables"))

    # ---- compilation ----------------------------------------------------
    def tables(self, p, n: int, a: int) -> TopoTables:
        """Compile the placement + level declarations into the static
        per-(core, bank) hop/latency/crossing tables."""
        cc = np.asarray(self.core_clusters(p, n), np.int32)
        bc = np.asarray(self.bank_clusters(p, a), np.int32)
        if cc.shape != (n,) or bc.shape != (a,):
            raise ValueError(
                f"topology {self.name!r}: placement shapes {cc.shape}/"
                f"{bc.shape} do not match (n={n}, a={a})")
        hops = np.ones((n, a), np.int32)
        extra = np.zeros((n, a), np.int32)
        cross = []
        for lv, spec in enumerate(self.levels):
            cl = self.level_cluster(cc, lv, p)[:, None]
            bl = self.level_cluster(bc, lv, p)[None, :]
            x = cl != bl
            cross.append(x)
            hops = hops + 2 * x.astype(np.int32)
            extra = extra + spec.extra_lat * x.astype(np.int32)
        return TopoTables(hops=hops, extra=extra, cross=tuple(cross),
                          core_cluster=cc, bank_cluster=bc,
                          is_flat=not self.levels)
