"""Spin-lock baselines protecting the bin: ``amo_lock``, ``lrsc_lock``,
``ticket_lock``.

* ``amo_lock``    — test&set via a single AMO; failed attempts back off
                    with the paper's fixed 128-cycle policy and re-poll.
* ``lrsc_lock``   — the same lock built from an LR/SC pair: two round
                    trips per acquire attempt and double the messages.
* ``ticket_lock`` — FIFO spin lock: the first attempt draws a ticket from
                    the bank's dispenser; re-polls re-check ``serving``
                    against the core's held ticket.  Still polling-based
                    (retry traffic like ``amo_lock``) but grants strictly
                    in ticket order.

Under the reservation watchdog a spin lock whose last grantee is dead
is force-freed, and the ticket lock's ``serving`` skips a dead holder's
ticket.
"""
from __future__ import annotations

import torch

from repro_torch.core.protocols.base import (KERNEL_LOCK, KERNEL_TICKET,
                                             MSGS_ACQ, MSGS_NONE, NXT_BACKOFF,
                                             NXT_MOD, NXT_WORK_DONE, OUT_DONE,
                                             OUT_EVICT, OUT_FAIL, OUT_GRANT,
                                             OUT_NONE, Contract, FusedOut,
                                             KernelArgs, Protocol,
                                             _owner_dead, count, respond)
from repro_torch.core.protocols.registry import register


class SpinLock(Protocol):
    fixed_backoff = True
    lr_pair = False          # lrsc_lock: LR+SC = two round trips per attempt
    # test&set semantics: the lock grant is exclusive, but losers poll
    # (OUT_FAIL → backoff → retry) — the paper's retry-traffic baseline
    contract = Contract(exclusive_grant=True, retry_free=False,
                        wait_class=False, max_hot_scatters=2)
    kernel_code = KERNEL_LOCK

    def acq_tmr(self, p) -> int:
        """Response timer of an acquire attempt: one round trip, two for
        an LR/SC pair."""
        return 2 * p.lat if self.lr_pair else p.lat

    def kernel_args(self, p):
        return KernelArgs(msg_rule=MSGS_ACQ if self.lr_pair else MSGS_NONE,
                          acq_tmr=self.acq_tmr(p))

    def init_bank_state(self, p, a, n, q_cap, device):
        return dict(lock=torch.zeros((a,), dtype=torch.bool, device=device))

    def on_access(self, ctx, cs, bank):
        lock = bank["lock"]
        free = ~lock[ctx.wa]
        got = ctx.is_acq & free
        fail = ctx.is_acq & ~free
        respond(cs, ctx.is_acq, self.acq_tmr(ctx.p),
                torch.where(got, NXT_MOD,
                            torch.where(fail, NXT_BACKOFF, cs["nxt"])))
        cs["polls"] = cs["polls"] + count(fail)
        if self.lr_pair:
            cs["msgs"] = cs["msgs"] + 2 * count(ctx.is_acq)
        respond(cs, ctx.is_rel, ctx.p.lat, NXT_WORK_DONE)
        # dense bank update: a winner is either acq or rel, never both
        bank = dict(bank, lock=(lock | (ctx.acq_b & ~lock)) & ~ctx.rel_b)
        return cs, bank

    def fused_access(self, fx, bank):
        lock = bank["lock"]
        got_b = fx.acq_b & ~lock
        fail_b = fx.acq_b & lock
        kind = torch.where(
            got_b, OUT_GRANT,
            torch.where(fail_b, OUT_FAIL,
                        torch.where(fx.rel_b, OUT_DONE, OUT_NONE))
        ).to(torch.int32)
        tmr = torch.where(fx.acq_b, self.acq_tmr(fx.p),
                          fx.p.lat).to(torch.int32)
        msgs = 2 * fx.acq_b.to(torch.int32) if self.lr_pair else None
        bank = dict(bank, lock=(lock | got_b) & ~fx.rel_b)
        return bank, FusedOut(kind=kind, tmr=tmr, msgs=msgs)

    # ---- fault recovery: timeout-and-retry ------------------------------
    # a lock held with no release for watchdog_cyc whose holder is
    # permanently dead is force-freed; the spinners' re-polls take it
    def held(self, bank):
        return bank["lock"]

    def on_timeout(self, ctx, cs, bank, stuck_b, killed, owner):
        free_b = stuck_b & _owner_dead(killed, owner, ctx.n)
        bank = dict(bank, lock=bank["lock"] & ~free_b)
        return cs, bank, torch.where(free_b, OUT_EVICT,
                                     OUT_NONE).to(torch.int32)


@register
class AmoLock(SpinLock):
    name = "amo_lock"


@register
class LrscLock(SpinLock):
    name = "lrsc_lock"
    lr_pair = True


@register
class TicketLock(Protocol):
    name = "ticket_lock"
    fixed_backoff = True
    # polling like the spin locks (re-polls fail until `serving`
    # matches), but grants are exclusive and strictly ticket-ordered
    contract = Contract(exclusive_grant=True, retry_free=False,
                        wait_class=False, max_hot_scatters=2)
    kernel_code = KERNEL_TICKET
    # the winner's held ticket is the one per-core value the bank needs,
    # and the drawn/dropped ticket is the one per-core value it writes
    fused_core_fields = ("tkt",)
    fused_xset_fields = ("tkt",)

    def init_bank_state(self, p, a, n, q_cap, device):
        return dict(
            next_tkt=torch.zeros((a,), dtype=torch.int32, device=device),
            serving=torch.zeros((a,), dtype=torch.int32, device=device),
        )

    def init_core_state(self, p, n, device):
        return dict(tkt=torch.full((n,), -1, dtype=torch.int32,
                                   device=device))

    def on_access(self, ctx, cs, bank):
        wa, is_acq, is_rel = ctx.wa, ctx.is_acq, ctx.is_rel
        next_tkt, serving = bank["next_tkt"], bank["serving"]
        tkt = cs["tkt"]
        # the first attempt draws a ticket; re-polls keep the one they hold
        draw = is_acq & (tkt < 0)
        my_tkt = torch.where(draw, next_tkt[wa], tkt)
        draw_b = ctx.acq_b & (tkt[ctx.win_core.clamp(max=ctx.n - 1)] < 0)
        next_tkt = next_tkt + draw_b.to(torch.int32)
        tkt = torch.where(is_acq, my_tkt, tkt)
        got = is_acq & (my_tkt == serving[wa])
        fail = is_acq & ~got
        respond(cs, is_acq, ctx.p.lat,
                torch.where(got, NXT_MOD,
                            torch.where(fail, NXT_BACKOFF, cs["nxt"])))
        cs["polls"] = cs["polls"] + count(fail)
        # release: advance the serving counter, drop the ticket
        serving = serving + ctx.rel_b.to(torch.int32)
        cs["tkt"] = tkt.masked_fill(is_rel, -1)
        respond(cs, is_rel, ctx.p.lat, NXT_WORK_DONE)
        bank = dict(bank, next_tkt=next_tkt, serving=serving)
        return cs, bank

    def fused_access(self, fx, bank):
        next_tkt, serving = bank["next_tkt"], bank["serving"]
        tkt_w = fx.core["tkt"]                    # winner's held ticket
        draw_b = fx.acq_b & (tkt_w < 0)
        my_tkt_b = torch.where(draw_b, next_tkt, tkt_w)
        next_tkt = next_tkt + draw_b.to(torch.int32)
        got_b = fx.acq_b & (my_tkt_b == serving)
        kind = torch.where(
            got_b, OUT_GRANT,
            torch.where(fx.acq_b, OUT_FAIL,
                        torch.where(fx.rel_b, OUT_DONE, OUT_NONE))
        ).to(torch.int32)
        tmr = torch.full_like(kind, fx.p.lat)
        serving = serving + fx.rel_b.to(torch.int32)
        bank = dict(bank, next_tkt=next_tkt, serving=serving)
        # acquires record their (kept or drawn) ticket; releases drop it
        xset = {"tkt": (torch.where(fx.rel_b, -1, my_tkt_b).to(torch.int32),
                        fx.acq_b | fx.rel_b)}
        return bank, FusedOut(kind=kind, tmr=tmr, xset=xset)

    # ---- fault recovery: skip the dead ticket ---------------------------
    def held(self, bank):
        return bank["serving"] < bank["next_tkt"]

    def on_timeout(self, ctx, cs, bank, stuck_b, killed, owner):
        skip_b = stuck_b & _owner_dead(killed, owner, ctx.n)
        # advance the serving counter past the dead holder's ticket; the
        # next waiter's re-poll matches and takes the lock
        bank = dict(bank, serving=bank["serving"] + skip_b.to(torch.int32))
        return cs, bank, torch.where(skip_b, OUT_EVICT,
                                     OUT_NONE).to(torch.int32)
