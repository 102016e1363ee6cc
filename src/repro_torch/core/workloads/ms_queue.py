"""``ms_queue`` — Michael–Scott-style concurrent queue traffic.

Each op is an enqueue/dequeue pair of *linked* atomics on the queue's
two hot words: the enqueue RMW swings the **tail** pointer (address 1,
link-update ``modify`` window), then after a short dependent-load gap
the dequeue RMW advances the **head** (address 0).  This is the Fig. 6
scenario as a two-atomic program: head and tail contend in their own
banks, and a core's dequeue never overtakes its own enqueue (program
order).

``check`` replays the completion trace as a linearizability /
conservation screen: at every cycle prefix pops ⊑ pushes, per-core ops
strictly alternate enqueue→dequeue, and head-bank commits are totally
ordered (≤ 1 pop retires per cycle — the single-ported bank is the
linearization point).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.workloads.base import (ADDR_FIXED, K_ATOMIC, Program,
                                             Workload)
from repro_torch.core.workloads.registry import register

HEAD, TAIL = 0, 1
ENQ, DEQ = 0, 1            # step ids in the program / trace
DEP_GAP = 2                # dependent-load gap between the linked atomics


@register
class MsQueue(Workload):
    name = "ms_queue"
    min_addrs = 2
    #: the Fig. 6 queue scenario: head+tail words, link-update modify
    scenario = {"n_addrs": 2, "modify": 8}

    def program(self, p) -> Program:
        return Program(kind=(K_ATOMIC, K_ATOMIC),
                       pre_mult=(1, 0), pre_add=(0, DEP_GAP),
                       addr_mode=(ADDR_FIXED, ADDR_FIXED),
                       addr_arg=(TAIL, HEAD),
                       mod_mult=(1, 1), mod_add=(0, 0))

    def check(self, p, res, trace=None):
        out = super().check(p, res, trace)
        if trace is None:
            return out
        trace = np.asarray(trace)
        pushes = (trace == ENQ).sum(axis=1)
        pops = (trace == DEQ).sum(axis=1)
        # pops ⊆ pushes at every prefix: every dequeue is covered by an
        # earlier enqueue (each core's deq is program-ordered after its enq)
        lead = np.cumsum(pushes) - np.cumsum(pops)
        assert lead.min() >= 0, f"pop overtook push (deficit {lead.min()})"
        # FIFO per-bank order: the head bank serves at most one dequeue
        # per cycle, so pop order is a total order
        assert pops.max(initial=0) <= 1, "two pops retired in one cycle"
        # per-core program order: strict enq→deq alternation
        for c, seq in self._per_core_steps(trace):
            want = np.arange(len(seq)) % 2
            assert np.array_equal(seq, want), f"core {c} broke enq/deq order"
        out["pushes"] = int(pushes.sum())
        out["pops"] = int(pops.sum())
        return out
