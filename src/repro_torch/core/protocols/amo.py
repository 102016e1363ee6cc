"""``amo`` — single-instruction atomic add (Fig. 3 roofline).

No bank state: the RMW commits in one bank access, the response sends the
core straight back to work.  Every generic-RMW protocol is bounded above
by this line.
"""
from __future__ import annotations

import torch

from repro_torch.core.protocols.base import (KERNEL_AMO, NXT_WORK_DONE,
                                             OUT_DONE, OUT_NONE, Contract,
                                             FusedOut, Protocol, respond)
from repro_torch.core.protocols.registry import register


@register
class Amo(Protocol):
    name = "amo"
    # one access commits the op: no retries, no waiting, nothing held
    contract = Contract(exclusive_grant=True, retry_free=True,
                        wait_class=False, max_hot_scatters=2)
    kernel_code = KERNEL_AMO

    def on_access(self, ctx, cs, bank):
        respond(cs, ctx.is_acq, ctx.p.lat, NXT_WORK_DONE)
        return cs, bank

    def fused_access(self, fx, bank):
        # the AMO commits at the bank: every acquire winner retires in
        # one access (amo cores never issue a release phase)
        kind = torch.where(fx.acq_b, OUT_DONE, OUT_NONE).to(torch.int32)
        tmr = torch.full_like(kind, fx.p.lat)
        return bank, FusedOut(kind=kind, tmr=tmr)
