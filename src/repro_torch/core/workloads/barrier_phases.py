"""``barrier_phases`` — bulk-synchronous compute/barrier phases (the
1024-core barrier study scenario, arXiv:2307.10248).

Each op is one phase: a compute segment (``COMPUTE_MULT × work``
cycles), then a barrier — an arrival atomic (fetch-and-increment, 1
cycle in the bank) on the barrier counter word issued *through the
active protocol*, after which the core parks in ``BARWAIT`` until every
participating core has arrived and the engine broadcasts the release
(one message per waiter, one response latency).

The protocol therefore owns exactly what the barrier papers measure:
the arrival contention on one hot word.  Retry-based protocols (LRSC,
spin locks) storm the counter as core counts grow; queue-based arrivals
(LRSCwait/Colibri/Mwait) stay polling-free.

``check`` asserts the bulk-synchronous laws: no core is ever a full
phase ahead (per-core completed phases span ≤ 1) and arrivals balance
(``bar_cnt`` equals completed atomics per core).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.workloads.base import (ADDR_FIXED, K_BARRIER, Program,
                                             Workload)
from repro_torch.core.workloads.registry import register

BARRIER_ADDR = 0
COMPUTE_MULT = 4           # compute segment = 4 × the `work` scalar


@register
class BarrierPhases(Workload):
    name = "barrier_phases"
    scenario = {"n_addrs": 1}                    # one arrival counter

    def program(self, p) -> Program:
        return Program(kind=(K_BARRIER,),
                       pre_mult=(COMPUTE_MULT,), pre_add=(0,),
                       addr_mode=(ADDR_FIXED,), addr_arg=(BARRIER_ADDR,),
                       mod_mult=(0,), mod_add=(1,))

    def check(self, p, res, trace=None):
        out = super().check(p, res, trace)
        nw = min(p.n_workers, p.n_cores)
        ops = np.asarray(res["ops"])[nw:]
        bar = np.asarray(res["bar_cnt"])[nw:]
        if ops.size:
            span = int(ops.max()) - int(ops.min())
            assert span <= 1, f"barrier let a core run {span} phases ahead"
            assert np.array_equal(bar, np.asarray(res["opc"])[nw:]), \
                "arrival count out of sync with completed atomics"
            out["phases"] = int(ops.min())
        return out
