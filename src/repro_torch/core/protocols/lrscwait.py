"""``lrscwait`` — LRwait/SCwait with q reservation slots per bank.

Linearizes contending RMWs at the LR: an LRwait to a non-empty queue
enqueues and the core sleeps (no polling); the SCwait always succeeds and
wakes the next head.  With q ≥ N this is LRSCwait_ideal; an LRwait to a
FULL queue fails immediately and falls back to retry traffic (the
capacity collapse of Fig. 3's ``LRSCwait_q`` lines).
"""
from __future__ import annotations

import torch

from repro_torch.core.protocols.base import (KERNEL_QUEUE, MSGS_ENQ_PEND,
                                             MSGS_NONE, NXT_BACKOFF, NXT_MOD,
                                             NXT_WORK_DONE, OUT_DONE,
                                             OUT_FAIL, OUT_GRANT, OUT_NONE,
                                             OUT_SLEEP, SLEEP, Contract,
                                             FifoQueueRecovery, FusedOut,
                                             KernelArgs, Protocol, count,
                                             enqueue, respond)
from repro_torch.core.protocols.registry import register


@register
class LrscWait(FifoQueueRecovery, Protocol):
    # the FIFO watchdog recovery applies directly: the queue head IS the
    # reservation owner (grantees enqueue too)
    name = "lrscwait"
    uses_queue = True
    # wait-class: contenders sleep in the bank queue; OUT_FAIL only at a
    # full queue (the finite-q capacity collapse of Fig. 3)
    contract = Contract(exclusive_grant=True, wait_class=True,
                        fail_requires_full=True, queue_counts_holder=True,
                        max_hot_scatters=4)
    kernel_code = KERNEL_QUEUE
    #: colibri: SuccessorUpdate on enqueue-behind + WakeUpRequest round trip
    successor_updates = False

    def q_cap(self, p, n):
        return min(p.q_slots, n)

    def wake_delay(self, p):
        return p.lat

    def kernel_args(self, p):
        return KernelArgs(
            self.wake_delay(p),
            MSGS_ENQ_PEND if self.successor_updates else MSGS_NONE, p.lat,
            self.q_cap(p, p.n_cores))

    def init_bank_state(self, p, a, n, q_cap, device):
        def z():
            return torch.zeros((a,), dtype=torch.int32, device=device)
        return dict(
            qbuf=torch.full((a, q_cap), -1, dtype=torch.int32, device=device),
            qhead=z(), qlen=z(), wake_tmr=z(),
        )

    def on_access(self, ctx, cs, bank):
        p, wa, q_cap = ctx.p, ctx.wa, ctx.q_cap
        is_acq, acq_b, rel_b = ctx.is_acq, ctx.acq_b, ctx.rel_b
        qhead, qlen = bank["qhead"], bank["qlen"]
        empty = qlen[wa] == 0
        full = qlen[wa] >= q_cap
        grant = is_acq & empty
        enq = is_acq & ~empty & ~full
        rej = is_acq & full                  # finite-q immediate fail
        put_b = acq_b & (qlen < q_cap)
        qbuf = enqueue(bank["qbuf"], put_b, qhead, qlen, ctx.win_core,
                       q_cap)
        respond(cs, grant, p.lat, NXT_MOD)
        cs["st"] = cs["st"].masked_fill(enq, SLEEP)
        respond(cs, rej, p.lat, NXT_BACKOFF)
        cs["polls"] = cs["polls"] + count(rej)
        if self.successor_updates:           # SuccessorUpdate round trip
            cs["msgs"] = cs["msgs"] + 2 * count(enq)
        # SCwait: always valid (only the head ever gets a response)
        qhead = torch.where(rel_b, torch.remainder(qhead + 1, q_cap), qhead)
        qlen = qlen + put_b.to(torch.int32) - rel_b.to(torch.int32)
        respond(cs, ctx.is_rel, p.lat, NXT_WORK_DONE)
        pend_b = rel_b & (qlen > 0)
        wake_tmr = torch.where(pend_b, self.wake_delay(p), bank["wake_tmr"])
        if self.successor_updates:           # WakeUpRequest round trip
            cs["msgs"] = cs["msgs"] + 2 * count(pend_b)
        bank = dict(bank, qbuf=qbuf, qhead=qhead, qlen=qlen,
                    wake_tmr=wake_tmr)
        return cs, bank

    def fused_access(self, fx, bank):
        q_cap = fx.q_cap
        qbuf, qhead, qlen = bank["qbuf"], bank["qhead"], bank["qlen"]
        empty_b = qlen == 0
        full_b = qlen >= q_cap
        grant_b = fx.acq_b & empty_b
        enq_b = fx.acq_b & ~empty_b & ~full_b
        rej_b = fx.acq_b & full_b                # finite-q immediate fail
        put_b = fx.acq_b & ~full_b
        qbuf = enqueue(qbuf, put_b, qhead, qlen, fx.win, q_cap)
        kind = torch.where(
            grant_b, OUT_GRANT,
            torch.where(enq_b, OUT_SLEEP,
                        torch.where(rej_b, OUT_FAIL,
                                    torch.where(fx.rel_b, OUT_DONE,
                                                OUT_NONE)))
        ).to(torch.int32)
        tmr = torch.full_like(kind, fx.p.lat)
        # SCwait: always valid (only the head ever gets a response)
        qhead = torch.where(fx.rel_b, torch.remainder(qhead + 1, q_cap),
                            qhead)
        qlen = (qlen + put_b.to(torch.int32) - fx.rel_b.to(torch.int32))
        pend_b = fx.rel_b & (qlen > 0)
        wake_tmr = torch.where(pend_b, self.wake_delay(fx.p),
                               bank["wake_tmr"])
        msgs = None
        if self.successor_updates:               # SuccUpdate + WakeUpReq RTs
            msgs = 2 * (enq_b.to(torch.int32) + pend_b.to(torch.int32))
        bank = dict(bank, qbuf=qbuf, qhead=qhead, qlen=qlen,
                    wake_tmr=wake_tmr)
        return bank, FusedOut(kind=kind, tmr=tmr, msgs=msgs)
