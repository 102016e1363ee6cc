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
                                             MSGS_NONE, OUT_DONE, OUT_FAIL,
                                             OUT_GRANT, OUT_NONE, OUT_SLEEP,
                                             Contract, FusedOut, Protocol)
from repro_torch.core.protocols.registry import register


@register
class LrscWait(Protocol):
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
        return (self.wake_delay(p),
                MSGS_ENQ_PEND if self.successor_updates else MSGS_NONE, p.lat,
                self.q_cap(p, p.n_cores))

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
        full_b = qlen >= q_cap
        grant_b = fx.acq_b & empty_b
        enq_b = fx.acq_b & ~empty_b & ~full_b
        rej_b = fx.acq_b & full_b                # finite-q immediate fail
        put_b = fx.acq_b & ~full_b
        slot_b = torch.remainder(qhead + qlen, q_cap)
        # the winner lands in its queue slot; banks without a put keep
        # the slot's old value (a masked write, no index out of range)
        ba = torch.arange(qbuf.shape[0], device=qbuf.device)
        qbuf = qbuf.clone()
        qbuf[ba, slot_b] = torch.where(put_b, fx.win, qbuf[ba, slot_b])
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
