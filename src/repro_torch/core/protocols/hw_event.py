"""``hw_event`` — per-cluster hardware event unit (Glaser et al.,
arXiv:2004.06662).

Each cluster owns a synchronization unit next to its cores: a waiter
registers with its local unit and clock-gates, and a release inside the
cluster raises the unit's single-cycle wakeup line.  Across clusters the
units form a combining tree: a cluster with waiters asserts one upward
combine signal (1 message), and a releasing cluster whose local waiters
drained hands the resource to the next registered cluster over the NoC
(``lat + 1``, 2 messages).

Structurally this is ``colibri_hier`` (:class:`TwoLevelQueues`) with the
reservation Qnodes replaced by hardware units: the same cluster-local
queues and global FIFO of clusters, but no turn budget (a unit serves
its cluster until the local wait set drains) and its own delays and
messages.  The unit's cluster is a topology cluster on a hierarchical
topology and an ``n_groups`` group on the flat crossbar.  Its watchdog
recovery is the two-level queues' hand-off replay, handing a group on
after ``lat + 1``.
"""
from __future__ import annotations

from repro_torch.core.protocols.base import (KERNEL_EVENT, MSGS_EVENT,
                                             Contract)
from repro_torch.core.protocols.colibri_hier import TwoLevelQueues
from repro_torch.core.protocols.registry import register


@register
class HwEvent(TwoLevelQueues):
    name = "hw_event"
    local_delay = 1          # single-cycle intra-cluster wakeup broadcast
    handoff_extra = 1        # the cross-cluster wire + the unit's cycle
    turn_budget = False
    # registration rides on the request; the upward combine line is one
    # message, the cross-cluster hand-off two
    msgs_enq, msgs_reg, msgs_local, msgs_rereg, msgs_handoff = 0, 1, 0, 0, 2
    msg_rule = MSGS_EVENT
    contract = Contract(exclusive_grant=True, wait_class=True,
                        retry_free=True, queue_counts_holder=False,
                        max_hot_scatters=10)
    kernel_code = KERNEL_EVENT

    @staticmethod
    def _geom(p, n):
        """(units, cluster size, local queue capacity): one unit per
        topology cluster on a hierarchical topology, one per
        ``n_groups`` on the flat crossbar."""
        knob = (p.clusters if getattr(p, "topology", "flat") != "flat"
                else p.n_groups)
        g = max(1, min(knob, n))
        gsz = max(1, n // g)
        cap_l = max(gsz, n - (g - 1) * gsz)  # last cluster may be larger
        return g, gsz, cap_l
