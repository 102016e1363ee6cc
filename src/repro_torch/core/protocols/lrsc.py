"""``lrsc`` — MemPool-style LR/SC with ONE reservation slot per bank.

An LR takes the slot only if free; otherwise it still gets the value but
its SC is doomed (the "sacrificed non-blocking property").  Failed SC →
backoff → full LRSC retry: the retry storm the paper measures.
"""
from __future__ import annotations

import torch

from repro_torch.core.protocols.base import (KERNEL_LRSC, NXT_BACKOFF,
                                             NXT_MOD, NXT_WORK_DONE, OUT_DONE,
                                             OUT_EVICT, OUT_FAIL, OUT_GRANT,
                                             OUT_NONE, Contract, FusedOut,
                                             Protocol, count, respond)
from repro_torch.core.protocols.registry import register


@register
class Lrsc(Protocol):
    name = "lrsc"
    # every LR is answered (a taken slot only dooms the SC), so grants
    # are NOT exclusive and the doomed-SC retry loop is expected
    contract = Contract(exclusive_grant=False, retry_free=False,
                        wait_class=False, evict_live_safe=True,
                        max_hot_scatters=2)
    kernel_code = KERNEL_LRSC

    def init_bank_state(self, p, a, n, q_cap, device):
        return dict(
            resv_core=torch.full((a,), -1, dtype=torch.int32, device=device),
            resv_valid=torch.zeros((a,), dtype=torch.bool, device=device),
        )

    def on_access(self, ctx, cs, bank):
        lat, win = ctx.p.lat, ctx.win_core
        resv_core, resv_valid = bank["resv_core"], bank["resv_valid"]
        # bank state is dense over banks: a bank's one winner is an
        # acquire or a release, never both
        got_resv_b = ctx.acq_b & ~resv_valid
        resv_core = torch.where(got_resv_b, win, resv_core)
        respond(cs, ctx.is_acq, lat, NXT_MOD)
        # SC: succeeds iff holding the reservation; owner's SC releases it
        owner_b = ctx.rel_b & resv_valid & (resv_core == win)
        owner = ctx.is_rel & owner_b[ctx.wa]
        fail = ctx.is_rel & ~owner
        resv_valid = (resv_valid | got_resv_b) & ~owner_b
        respond(cs, ctx.is_rel, lat,
                torch.where(owner, NXT_WORK_DONE,
                            torch.where(fail, NXT_BACKOFF, cs["nxt"])))
        cs["polls"] = cs["polls"] + count(fail)
        bank = dict(bank, resv_core=resv_core, resv_valid=resv_valid)
        return cs, bank

    def fused_access(self, fx, bank):
        resv_core, resv_valid = bank["resv_core"], bank["resv_valid"]
        # LR: always answered (a taken slot just dooms the later SC)
        got_resv_b = fx.acq_b & ~resv_valid
        resv_core = torch.where(got_resv_b, fx.win, resv_core)
        # SC: succeeds iff holding the reservation; owner's SC releases it
        owner_b = fx.rel_b & resv_valid & (resv_core == fx.win)
        resv_valid = (resv_valid | got_resv_b) & ~owner_b
        kind = torch.where(
            fx.acq_b, OUT_GRANT,
            torch.where(owner_b, OUT_DONE,
                        torch.where(fx.rel_b, OUT_FAIL, OUT_NONE))
        ).to(torch.int32)
        tmr = torch.full_like(kind, fx.p.lat)
        bank = dict(bank, resv_core=resv_core, resv_valid=resv_valid)
        return bank, FusedOut(kind=kind, tmr=tmr)

    # ---- fault recovery: expire the stale slot --------------------------
    # hardware reservations time out; a slot pinned with no successful
    # SC for watchdog_cyc is expired whatever its owner's state (a live
    # owner just sees its SC fail and retries, which IS the lrsc
    # recovery path)
    def held(self, bank):
        return bank["resv_valid"]

    def on_timeout(self, ctx, cs, bank, stuck_b, killed, owner):
        bank = dict(bank, resv_valid=bank["resv_valid"] & ~stuck_b)
        return cs, bank, torch.where(stuck_b, OUT_EVICT,
                                     OUT_NONE).to(torch.int32)
