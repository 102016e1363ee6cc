"""``mwait_lock`` — MCS queue lock where waiters sleep via Mwait.

Contenders enqueue at the bank and sleep (Mwait setup costs messages);
the releaser wakes its successor directly — polling-free, but every
critical section pays lock-management round trips that the direct
LRSCwait RMW avoids.  The head of the queue is the lock holder, so the
FIFO watchdog recovery (``FifoQueueRecovery``) applies: evict a dead
holder, wake the successor.
"""
from __future__ import annotations

import torch

from repro_torch.core.protocols.base import (KERNEL_QUEUE, MSGS_ENQ,
                                             NEVER_FULL, NXT_MOD,
                                             NXT_WORK_DONE, OUT_DONE,
                                             OUT_GRANT, OUT_NONE, OUT_SLEEP,
                                             SLEEP, Contract,
                                             FifoQueueRecovery, FusedOut,
                                             KernelArgs, Protocol, count,
                                             enqueue, respond)
from repro_torch.core.protocols.registry import register


@register
class MwaitLock(FifoQueueRecovery, Protocol):
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
        return KernelArgs(self.wake_delay(p), MSGS_ENQ, p.lat, NEVER_FULL)

    def init_bank_state(self, p, a, n, q_cap, device):
        def z():
            return torch.zeros((a,), dtype=torch.int32, device=device)
        return dict(
            qbuf=torch.full((a, q_cap), -1, dtype=torch.int32, device=device),
            qhead=z(), qlen=z(), wake_tmr=z(),
        )

    def on_access(self, ctx, cs, bank):
        p, q_cap, acq_b, rel_b = ctx.p, ctx.q_cap, ctx.acq_b, ctx.rel_b
        qhead, qlen = bank["qhead"], bank["qlen"]
        empty = qlen[ctx.wa] == 0
        grant = ctx.is_acq & empty
        enq = ctx.is_acq & ~empty
        qbuf = enqueue(bank["qbuf"], acq_b, qhead, qlen, ctx.win_core,
                       q_cap)
        respond(cs, grant, p.lat, NXT_MOD)
        cs["st"] = cs["st"].masked_fill(enq, SLEEP)
        cs["msgs"] = cs["msgs"] + 2 * count(enq)         # Mwait setup
        qhead = torch.where(rel_b, torch.remainder(qhead + 1, q_cap), qhead)
        qlen = qlen + acq_b.to(torch.int32) - rel_b.to(torch.int32)
        respond(cs, ctx.is_rel, p.lat, NXT_WORK_DONE)
        pend_b = rel_b & (qlen > 0)
        # the releaser wakes its successor
        wake_tmr = torch.where(pend_b, self.wake_delay(p), bank["wake_tmr"])
        bank = dict(bank, qbuf=qbuf, qhead=qhead, qlen=qlen,
                    wake_tmr=wake_tmr)
        return cs, bank

    def fused_access(self, fx, bank):
        q_cap = fx.q_cap
        qbuf, qhead, qlen = bank["qbuf"], bank["qhead"], bank["qlen"]
        empty_b = qlen == 0
        grant_b = fx.acq_b & empty_b
        enq_b = fx.acq_b & ~empty_b
        qbuf = enqueue(qbuf, fx.acq_b, qhead, qlen, fx.win, q_cap)
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
