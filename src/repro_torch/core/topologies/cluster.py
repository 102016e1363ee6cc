"""Hierarchical cluster topologies (arXiv:2307.10248 latency model).

``cluster2``
    Two-level machine: ``p.clusters`` leaf clusters of cores, banks
    interleaved across the cluster-local SPMs.  A request leaving its
    cluster pays +8 cycles round trip and contends for a cross-cluster
    link budget of ``net_bw // 4`` acceptances per cycle.

``cluster3``
    Three-level machine: leaf clusters pair into groups (the
    ``leaf >> 1`` default tree), with a cheaper intra-group boundary
    (+6 cycles, ``net_bw // 2``) and an expensive top-level crossing
    (+12 cycles, ``net_bw // 8``).  A top-level crossing pays both
    boundaries (hops = 5, extra = 18).
"""
from __future__ import annotations

from repro_torch.core.topologies.base import LinkLevel, Topology
from repro_torch.core.topologies.registry import register


@register
class Cluster2(Topology):
    name = "cluster2"
    levels = (LinkLevel("cluster", extra_lat=8, bw_div=4),)


@register
class Cluster3(Topology):
    name = "cluster3"
    levels = (LinkLevel("cluster", extra_lat=6, bw_div=2),
              LinkLevel("group", extra_lat=12, bw_div=8))
