"""``nb_feb`` — full/empty-bit atomics as a retry-free universal
primitive (NB-FEB, arXiv:0811.1304).

Every synchronization word carries a full/empty bit.  An acquire is a
``readFE``: when the bit is full the word is handed over and the bit
flips to empty in the same bank access; when it is empty the requester
joins the bank-side waiter FIFO and parks clock-gated.  Every acquirer
enters the FIFO (the grantee at its head), so the head is the owner.  The
release is a ``writeEF``: it pops the owner, then hands the word to the
new head (the bit stays empty) or sets the bit full when nobody waits.

The FIFO holds one entry per core, so there is no full-queue ``OUT_FAIL``
path at any core count.  In every reachable state ``feb == (qlen ==
0)``; the kernels carry the bit as state of its own all the same and
update it as :meth:`NbFeb.fused_access` does.  The watchdog recovery is
the FIFO eviction (``FifoQueueRecovery``) followed by the bit's
re-derivation ``feb = qlen == 0``.
"""
from __future__ import annotations

import torch

from repro_torch.core.protocols.base import (KERNEL_FEB, MSGS_NONE,
                                             NEVER_FULL, NXT_MOD,
                                             NXT_WORK_DONE, OUT_DONE,
                                             OUT_GRANT, OUT_NONE, OUT_SLEEP,
                                             SLEEP, Contract,
                                             FifoQueueRecovery, FusedOut,
                                             KernelArgs, Protocol, enqueue,
                                             respond)
from repro_torch.core.protocols.registry import register


@register
class NbFeb(FifoQueueRecovery, Protocol):
    name = "nb_feb"
    uses_queue = True
    contract = Contract(exclusive_grant=True, wait_class=True,
                        retry_free=True, queue_counts_holder=True,
                        max_hot_scatters=4)
    # the queue branch of the CUDA kernels with the bit in front of it:
    # q_cap = n (the default ``q_cap``), no rejection
    kernel_code = KERNEL_FEB

    def wake_delay(self, p):
        return p.lat

    def kernel_args(self, p):
        return KernelArgs(self.wake_delay(p), MSGS_NONE, p.lat, NEVER_FULL)

    def init_bank_state(self, p, a, n, q_cap, device):
        def z():
            return torch.zeros((a,), dtype=torch.int32, device=device)
        return dict(
            feb=torch.ones((a,), dtype=torch.bool, device=device),  # full
            qbuf=torch.full((a, q_cap), -1, dtype=torch.int32, device=device),
            qhead=z(), qlen=z(), wake_tmr=z(),
        )

    def on_access(self, ctx, cs, bank):
        p, q_cap, acq_b, rel_b = ctx.p, ctx.q_cap, ctx.acq_b, ctx.rel_b
        feb = bank["feb"]
        qhead, qlen = bank["qhead"], bank["qlen"]
        # readFE: bit full -> take the word (the bit flips empty); bit
        # empty -> join the waiter FIFO and sleep.  Never fails
        grant = ctx.is_acq & feb[ctx.wa]
        enq = ctx.is_acq & ~feb[ctx.wa]
        # every acquirer enters the FIFO (the grantee at its head)
        qbuf = enqueue(bank["qbuf"], acq_b, qhead, qlen, ctx.win_core,
                       q_cap)
        feb = feb & ~acq_b
        respond(cs, grant, p.lat, NXT_MOD)
        cs["st"] = cs["st"].masked_fill(enq, SLEEP)
        # writeEF: pop the owner; hand off to the new head, or set the
        # bit full when the FIFO drained
        qhead = torch.where(rel_b, torch.remainder(qhead + 1, q_cap), qhead)
        qlen = qlen + acq_b.to(torch.int32) - rel_b.to(torch.int32)
        respond(cs, ctx.is_rel, p.lat, NXT_WORK_DONE)
        pend_b = rel_b & (qlen > 0)
        feb = feb | (rel_b & (qlen == 0))
        wake_tmr = torch.where(pend_b, self.wake_delay(p), bank["wake_tmr"])
        bank = dict(bank, feb=feb, qbuf=qbuf, qhead=qhead, qlen=qlen,
                    wake_tmr=wake_tmr)
        return cs, bank

    def fused_access(self, fx, bank):
        q_cap = fx.q_cap
        feb = bank["feb"]
        qbuf, qhead, qlen = bank["qbuf"], bank["qhead"], bank["qlen"]
        # readFE: bit full -> take the word; bit empty -> wait.  Never
        # fails, and every acquirer lands in its queue slot
        grant_b = fx.acq_b & feb
        enq_b = fx.acq_b & ~feb
        qbuf = enqueue(qbuf, fx.acq_b, qhead, qlen, fx.win, q_cap)
        feb = feb & ~fx.acq_b
        kind = torch.where(
            grant_b, OUT_GRANT,
            torch.where(enq_b, OUT_SLEEP,
                        torch.where(fx.rel_b, OUT_DONE, OUT_NONE))
        ).to(torch.int32)
        tmr = torch.full_like(kind, fx.p.lat)
        # writeEF: pop the owner; hand off to the new head, or set the bit
        # full when the FIFO drained
        qhead = torch.where(fx.rel_b, torch.remainder(qhead + 1, q_cap),
                            qhead)
        qlen = qlen + fx.acq_b.to(torch.int32) - fx.rel_b.to(torch.int32)
        pend_b = fx.rel_b & (qlen > 0)
        feb = feb | (fx.rel_b & (qlen == 0))
        wake_tmr = torch.where(pend_b, self.wake_delay(fx.p),
                               bank["wake_tmr"])
        bank = dict(bank, feb=feb, qbuf=qbuf, qhead=qhead, qlen=qlen,
                    wake_tmr=wake_tmr)
        return bank, FusedOut(kind=kind, tmr=tmr)

    def on_timeout(self, ctx, cs, bank, stuck_b, killed, owner):
        # the FIFO eviction; evicting the LAST entry must also set the
        # bit full again, or the bank refuses every later readFE
        cs, bank, kind = super().on_timeout(ctx, cs, bank, stuck_b,
                                            killed, owner)
        bank["feb"] = bank["qlen"] == 0
        return cs, bank, kind
