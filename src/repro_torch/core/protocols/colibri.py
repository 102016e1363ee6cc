"""``colibri`` — LRSCwait with an unbounded distributed queue.

Same queue semantics as ``lrscwait`` with q = N (the linked list of
per-core Qnodes never fills), but the wake-up takes an extra round trip
(SCwait → Qnode → WakeUpRequest → memory → LR response) and
SuccessorUpdates add network traffic.
"""
from __future__ import annotations

from repro_torch.core.protocols.base import Contract
from repro_torch.core.protocols.lrscwait import LrscWait
from repro_torch.core.protocols.registry import register


@register
class Colibri(LrscWait):
    name = "colibri"
    successor_updates = True
    # the distributed queue never fills (q = N): fully retry-free
    contract = Contract(exclusive_grant=True, wait_class=True,
                        retry_free=True, queue_counts_holder=True,
                        max_hot_scatters=4)

    def q_cap(self, p, n):
        return n                             # distributed queue never fills

    def wake_delay(self, p):
        # the WakeUpRequest is dispatched when the SCwait PASSES the Qnode,
        # travelling in parallel with it — the successor's response costs
        # one response latency plus a small Qnode bounce.
        return p.lat + 2
