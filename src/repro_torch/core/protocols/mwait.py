"""``mwait_lock`` — MCS queue lock where waiters sleep via Mwait.

Contenders enqueue at the bank and sleep (Mwait setup costs messages);
the releaser wakes its successor directly — polling-free, but every
critical section pays lock-management round trips that the direct
LRSCwait RMW avoids.  The fault recovery of the reference
(``FifoQueueRecovery``, ROADMAP A5) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.protocols.base import (KERNEL_QUEUE, MSGS_ENQ,
                                             NEVER_FULL, OUT_DONE, OUT_GRANT,
                                             OUT_NONE, OUT_SLEEP, Contract,
                                             FusedOut, Protocol)
from repro_torch.core.protocols.registry import register


@register
class MwaitLock(Protocol):
    # same queue shape as lrscwait (head = lock holder)
    name = "mwait_lock"
    uses_queue = True
    fixed_backoff = True
    # MCS-style queue sized one slot per core: contenders always park,
    # never poll — fully retry-free; the holder stays at the queue head
    # until its release pops it
    contract = Contract(exclusive_grant=True, wait_class=True,
                        retry_free=True, queue_counts_holder=True,
                        max_hot_scatters=4)
    # the queue branch of the CUDA kernel, with q_cap = n (the default
    # ``q_cap``) and no rejection: an acquire always enqueues
    kernel_code = KERNEL_QUEUE

    def wake_delay(self, p):
        # successor wake: one response latency + Qnode bounce (the same
        # cost the release-path wake pays)
        return p.lat + 2

    def kernel_args(self, p):
        return self.wake_delay(p), MSGS_ENQ, p.lat, NEVER_FULL

    def init_bank_state(self, p, a, n, q_cap, device):
        def z():
            return torch.zeros((a,), dtype=torch.int32, device=device)
        return dict(
            qbuf=torch.full((a, q_cap), -1, dtype=torch.int32, device=device),
            qhead=z(), qlen=z(), wake_tmr=z(),
        )

    def fused_access(self, fx, bank):
        q_cap = fx.q_cap
        qbuf, qhead, qlen = bank["qbuf"], bank["qhead"], bank["qlen"]
        empty_b = qlen == 0
        grant_b = fx.acq_b & empty_b
        enq_b = fx.acq_b & ~empty_b
        slot_b = torch.remainder(qhead + qlen, q_cap)
        # every acquire winner lands in its queue slot; the other banks
        # keep the slot's old value (a masked write)
        ba = torch.arange(qbuf.shape[0], device=qbuf.device)
        qbuf = qbuf.clone()
        qbuf[ba, slot_b] = torch.where(fx.acq_b, fx.win, qbuf[ba, slot_b])
        kind = torch.where(
            grant_b, OUT_GRANT,
            torch.where(enq_b, OUT_SLEEP,
                        torch.where(fx.rel_b, OUT_DONE, OUT_NONE))
        ).to(torch.int32)
        tmr = torch.full_like(kind, fx.p.lat)
        msgs = 2 * enq_b.to(torch.int32)               # Mwait setup
        qhead = torch.where(fx.rel_b, torch.remainder(qhead + 1, q_cap),
                            qhead)
        qlen = qlen + fx.acq_b.to(torch.int32) - fx.rel_b.to(torch.int32)
        pend_b = fx.rel_b & (qlen > 0)
        wake_tmr = torch.where(pend_b, self.wake_delay(fx.p),
                               bank["wake_tmr"])
        bank = dict(bank, qbuf=qbuf, qhead=qhead, qlen=qlen,
                    wake_tmr=wake_tmr)
        return bank, FusedOut(kind=kind, tmr=tmr, msgs=msgs)
