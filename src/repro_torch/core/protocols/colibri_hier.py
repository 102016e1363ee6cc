"""``colibri_hier`` — two-level Colibri: group-local queues + a global
spillover queue of groups.

Cores are partitioned into ``n_groups`` clusters.  Waiters enqueue in a
queue local to their (address, group) pair — a SuccessorUpdate that stays
inside the cluster and a wake-up that costs only an intra-cluster Qnode
bounce (2 cycles).  A group with waiters registers once in the address's
global FIFO of groups; when the serving group's local queue drains, the
release hands the address to the next registered group with the full
cross-cluster wake round trip (``lat + 2``).  A turn budget keeps groups
fair: after ``group_size`` ops a group with registered competitors
re-registers at the global tail and hands the address over.

Polling-free and retry-free: the local queues hold one outstanding RMW
per member core, so an acquire never bounces.  Grantees bypass the local
queues (a woken head is popped), so ``queue_depth`` counts the sleepers
only.  :class:`TwoLevelQueues` holds the masked and the fused form and
the watchdog recovery shared with ``hw_event``.
"""
from __future__ import annotations

import torch

from repro_torch.core.protocols.base import (KERNEL_HIER, MOD, MSGS_HIER,
                                             NXT_MOD, NXT_WORK_DONE,
                                             OUT_DONE, OUT_EVICT, OUT_GRANT,
                                             OUT_NONE, OUT_REDELIVER,
                                             OUT_SLEEP, SLEEP, Contract,
                                             FusedOut, KernelArgs, Protocol,
                                             _owner_dead, count, respond)
from repro_torch.core.protocols.registry import register


class TwoLevelQueues(Protocol):
    """Group-local FIFO queues of sleepers under a global FIFO of groups;
    the group holding the address serves its own waiters first.  The
    subclass sets its delays, its messages and whether a turn budget
    applies."""

    uses_queue = True
    #: cycles from a release to the wake of the next local waiter
    local_delay = 2
    #: a cross-group hand-off wakes after ``lat + handoff_extra`` cycles
    handoff_extra = 2
    #: a group with registered competitors yields after ``group_size`` ops
    turn_budget = True
    #: side messages per enqueue, per global registration, per local
    #: wake, per re-registration and per cross-group hand-off
    msgs_enq, msgs_reg, msgs_local, msgs_rereg, msgs_handoff = 1, 2, 1, 2, 2
    msg_rule = MSGS_HIER

    @staticmethod
    def _geom(p, n):
        """(n_groups, group_size, local queue capacity)."""
        g = max(1, min(p.n_groups, n))
        gsz = max(1, n // g)
        cap_l = max(gsz, n - (g - 1) * gsz)  # last group may be larger
        return g, gsz, cap_l

    def kernel_args(self, p):
        g, gsz, cap_l = self._geom(p, p.n_cores)
        return KernelArgs(wake_delay=p.lat + self.handoff_extra,
                          msg_rule=self.msg_rule, acq_tmr=p.lat,
                          groups=g, group_size=gsz, group_cap=cap_l,
                          local_delay=self.local_delay)

    def init_bank_state(self, p, a, n, q_cap, device):
        g, _, cap_l = self._geom(p, n)

        def full(shape, v, dtype=torch.int32):
            return torch.full(shape, v, dtype=dtype, device=device)
        bank = dict(
            lqbuf=full((a * g, cap_l), -1),
            lqhead=full((a * g,), 0),
            lqlen=full((a * g,), 0),
            ggq=full((a, g), -1),              # FIFO of group ids
            gqhead=full((a,), 0),
            gqlen=full((a,), 0),
            g_inq=full((a, g), False, torch.bool),
            cur_grp=full((a,), -1),            # group holding the turn
            turn_srv=full((a,), 0),            # ops served this turn
            wake_tmr=full((a,), 0),
            # the GROUP whose local queue to wake; on_wake rebuilds the
            # flat (address, group) queue id from it
            wake_grp=full((a,), 0),
        )
        if not self.turn_budget:
            del bank["turn_srv"]
        return bank

    def queue_depth(self, bank):
        # the sleepers of a bank: its G local queues summed
        a = bank["cur_grp"].shape[0]
        return bank["lqlen"].reshape(a, -1).sum(dim=1)

    def _msg_weights(self):
        """Side messages per event of an access (``bank_update``'s masks)."""
        return (("enq_b", self.msgs_enq), ("reg_b", self.msgs_reg),
                ("more_local_b", self.msgs_local),
                ("re_reg_b", self.msgs_rereg),
                ("have_next_b", self.msgs_handoff))

    def on_access(self, ctx, cs, bank):
        """The masked form: :meth:`bank_update` over the winners, and
        their answers written to the ``(n,)`` core lanes."""
        bank, up = self.bank_update(ctx.p, ctx.n, bank, ctx.win_core,
                                    ctx.acq_b, ctx.rel_b)
        idle = up["idle_b"][ctx.wa]
        respond(cs, ctx.is_acq & idle, ctx.p.lat, NXT_MOD)
        cs["st"] = cs["st"].masked_fill(ctx.is_acq & ~idle, SLEEP)
        cs["msgs"] = cs["msgs"] + sum(w * count(up[k])
                                      for k, w in self._msg_weights())
        respond(cs, ctx.is_rel, ctx.p.lat, NXT_WORK_DONE)
        return cs, bank

    def fused_access(self, fx, bank):
        bank, up = self.bank_update(fx.p, fx.n, bank, fx.win, fx.acq_b,
                                    fx.rel_b)
        i32 = torch.int32
        msgs = sum(w * up[k].to(i32) for k, w in self._msg_weights())
        kind = torch.where(
            up["grant_b"], OUT_GRANT,
            torch.where(up["enq_b"], OUT_SLEEP,
                        torch.where(fx.rel_b, OUT_DONE, OUT_NONE))
        ).to(i32)
        tmr = torch.full_like(kind, fx.p.lat)
        return bank, FusedOut(kind=kind, tmr=tmr, msgs=msgs)

    def bank_update(self, p, n, bank, win, acq_b, rel_b):
        """The bank side of an access, dense over the banks: the new bank
        state, and the per-bank masks of what happened (``idle_b``,
        ``grant_b``, ``enq_b``, ``reg_b``, ``more_local_b``,
        ``re_reg_b``, ``have_next_b``).  The reference's statements in
        its order: later ones read the state that earlier ones wrote
        (lqlen after the enqueue, gqlen after a registration, ggq's head
        after a re-registration)."""
        G, gsz, cap_l = self._geom(p, n)
        i32 = torch.int32
        lqbuf, lqhead, lqlen = bank["lqbuf"], bank["lqhead"], bank["lqlen"]
        ggq, gqhead, gqlen = bank["ggq"], bank["gqhead"], bank["gqlen"]
        g_inq, cur_grp = bank["g_inq"], bank["cur_grp"]
        turn_srv = bank.get("turn_srv")
        wake_tmr, wake_grp = bank["wake_tmr"], bank["wake_grp"]
        a = cur_grp.shape[0]
        ba = torch.arange(a, dtype=i32, device=cur_grp.device)
        g_b = (win.clamp(max=n - 1) // gsz).clamp_(max=G - 1)
        lq_b = ba * G + g_b
        # every bank owns its rows (lq_b, and ba of the (a, G) arrays), so
        # a masked write is a gather, a where and a scatter to distinct
        # indices
        lqbuf, ggq, g_inq = lqbuf.clone(), ggq.clone(), g_inq.clone()

        # ---- acquire ----
        idle_b = cur_grp < 0
        grant_b = acq_b & idle_b
        cur_grp = torch.where(grant_b, g_b, cur_grp)
        if self.turn_budget:
            turn_srv = turn_srv.masked_fill(grant_b, 0)
        enq_b = acq_b & ~idle_b
        slot_b = torch.remainder(lqhead[lq_b] + lqlen[lq_b], cap_l)
        lqbuf[lq_b, slot_b] = torch.where(enq_b, win, lqbuf[lq_b, slot_b])
        lqlen = lqlen.index_add(0, lq_b, enq_b.to(i32))
        reg_b = enq_b & (cur_grp != g_b) & ~g_inq[ba, g_b]
        gslot_b = torch.remainder(gqhead + gqlen, G)
        ggq[ba, gslot_b] = torch.where(reg_b, g_b, ggq[ba, gslot_b])
        gqlen = gqlen + reg_b.to(i32)
        g_inq[ba, g_b] = g_inq[ba, g_b] | reg_b

        # ---- release (the releaser's group is always cur_grp) ----
        if self.turn_budget:
            srv_b = turn_srv + 1
            exhausted_b = rel_b & (srv_b >= gsz) & (gqlen > 0)
        else:
            exhausted_b = re_reg_b = torch.zeros_like(rel_b)
        more_local_b = rel_b & (lqlen[lq_b] > 0) & ~exhausted_b
        wake_grp = torch.where(more_local_b, g_b, wake_grp)
        wake_tmr = wake_tmr.masked_fill(more_local_b, self.local_delay)
        if self.turn_budget:
            turn_srv = torch.where(more_local_b, srv_b, turn_srv)
            # yielding with waiters left: re-register at the global tail
            re_reg_b = rel_b & (lqlen[lq_b] > 0) & exhausted_b
            tail_b = torch.remainder(gqhead + gqlen, G)
            ggq[ba, tail_b] = torch.where(re_reg_b, g_b, ggq[ba, tail_b])
            gqlen = gqlen + re_reg_b.to(i32)
            g_inq[ba, g_b] = g_inq[ba, g_b] | re_reg_b
        # turn over: local queue drained, or budget spent with competitors
        end_turn_b = rel_b & ((lqlen[lq_b] == 0) | exhausted_b)
        have_next_b = end_turn_b & (gqlen > 0)
        next_g_b = ggq[ba, gqhead]
        cur_grp = torch.where(have_next_b, next_g_b, cur_grp)
        # (a bank without a next group reads and writes back one flag)
        g_inq[ba, next_g_b] = g_inq[ba, next_g_b] & ~have_next_b
        gqhead = torch.where(have_next_b, torch.remainder(gqhead + 1, G),
                             gqhead)
        gqlen = gqlen - have_next_b.to(i32)
        wake_grp = torch.where(have_next_b, next_g_b, wake_grp)
        wake_tmr = wake_tmr.masked_fill(have_next_b,
                                        p.lat + self.handoff_extra)
        if self.turn_budget:
            turn_srv = turn_srv.masked_fill(have_next_b, 0)
        # nothing left anywhere: the address goes idle
        cur_grp = cur_grp.masked_fill(end_turn_b & ~have_next_b, -1)

        bank = dict(bank, lqbuf=lqbuf, lqhead=lqhead, lqlen=lqlen, ggq=ggq,
                    gqhead=gqhead, gqlen=gqlen, g_inq=g_inq,
                    cur_grp=cur_grp, wake_tmr=wake_tmr, wake_grp=wake_grp)
        if self.turn_budget:
            bank["turn_srv"] = turn_srv
        return bank, dict(idle_b=idle_b, grant_b=grant_b, enq_b=enq_b,
                          reg_b=reg_b, more_local_b=more_local_b,
                          re_reg_b=re_reg_b, have_next_b=have_next_b)

    # ---- fault recovery --------------------------------------------------
    # The current holder is NOT queued (grantees skip the local queues;
    # woken heads are popped), so an eviction cannot pop the dead core:
    # it REPLAYS the release hand-off the dead owner would have made —
    # wake the serving group's next local waiter, else hand the address
    # to the next registered group (``lat + handoff_extra``), else go
    # idle.  The engine's last grantee (``owner``) says whether the
    # holder is dead.
    def held(self, bank):
        return bank["cur_grp"] >= 0

    def on_timeout(self, ctx, cs, bank, stuck_b, killed, owner):
        p, n, ba = ctx.p, ctx.n, ctx.ba
        G, _, _ = self._geom(p, n)
        i32 = torch.int32
        lqlen = bank["lqlen"]
        ggq, gqhead, gqlen = bank["ggq"], bank["gqhead"], bank["gqlen"]
        g_inq, cur_grp = bank["g_inq"].clone(), bank["cur_grp"]
        wake_tmr, wake_grp = bank["wake_tmr"], bank["wake_grp"]
        evict_b = stuck_b & _owner_dead(killed, owner, n)
        g = cur_grp.clamp(0, G - 1)
        more_local = evict_b & (lqlen[ba * G + g] > 0)
        wake_grp = torch.where(more_local, g, wake_grp)
        wake_tmr = wake_tmr.masked_fill(more_local, self.local_delay)
        end_b = evict_b & ~more_local
        have_next = end_b & (gqlen > 0)
        next_g = ggq[ba, gqhead]
        cur_grp = torch.where(have_next, next_g, cur_grp)
        # (a bank without a next group reads and writes back one flag)
        g_inq[ba, next_g] = g_inq[ba, next_g] & ~have_next
        gqhead = torch.where(have_next, torch.remainder(gqhead + 1, G),
                             gqhead)
        gqlen = gqlen - have_next.to(i32)
        wake_grp = torch.where(have_next, next_g, wake_grp)
        wake_tmr = wake_tmr.masked_fill(have_next,
                                        p.lat + self.handoff_extra)
        cur_grp = cur_grp.masked_fill(end_b & ~have_next, -1)
        # live owner, no progress: the recorded wake was lost — re-send
        redeliver_b = (stuck_b & ~evict_b
                       & (lqlen[ba * G + wake_grp] > 0))
        wake_tmr = wake_tmr.masked_fill(redeliver_b, self.local_delay)
        cs["msgs"] = cs["msgs"] + 2 * (more_local | have_next
                                       | redeliver_b).sum(dtype=i32)
        bank = dict(bank, ggq=ggq, gqhead=gqhead, gqlen=gqlen, g_inq=g_inq,
                    cur_grp=cur_grp, wake_tmr=wake_tmr, wake_grp=wake_grp)
        if self.turn_budget:
            bank["turn_srv"] = bank["turn_srv"].masked_fill(evict_b, 0)
        kind = torch.where(evict_b, OUT_EVICT,
                           torch.where(redeliver_b, OUT_REDELIVER,
                                       OUT_NONE)).to(i32)
        return cs, bank, kind

    def on_wake(self, ctx, cs, bank):
        """Fire wake-up timers: wake the head of the chosen group's local
        queue and pop it (it is now the address's holder)."""
        G, _, cap_l = self._geom(ctx.p, ctx.n)
        wake_tmr = bank["wake_tmr"]
        ba = ctx.ba if ctx.ba is not None else torch.arange(
            ctx.a, dtype=torch.int32, device=wake_tmr.device)
        wq = ba * G + bank["wake_grp"]          # flat local-queue id
        lqbuf, lqhead, lqlen = bank["lqbuf"], bank["lqhead"], bank["lqlen"]
        fire = wake_tmr == 1
        wake_tmr = (wake_tmr - 1).clamp_(min=0)
        head_core = lqbuf[wq, lqhead[wq]]
        valid = fire & (lqlen[wq] > 0)
        # non-firing banks write slot n of an (n+1)-long mask, cut off
        fire_core = head_core.masked_fill(~valid, ctx.n)
        woken = torch.zeros((ctx.n + 1,), dtype=torch.bool,
                            device=wake_tmr.device)
        woken[fire_core] = True
        woken = woken[:ctx.n]
        cs["st"] = cs["st"].masked_fill(woken, MOD)
        cs["tmr"] = torch.where(woken, ctx.mod_dur, cs["tmr"])
        popped = valid.to(torch.int32)
        lqhead = torch.remainder(lqhead.index_add(0, wq, popped), cap_l)
        lqlen = lqlen.index_add(0, wq, -popped)
        bank = dict(bank, wake_tmr=wake_tmr, lqhead=lqhead, lqlen=lqlen)
        return cs, bank, (wake_tmr == 1).sum(dtype=torch.int32)


@register
class ColibriHier(TwoLevelQueues):
    name = "colibri_hier"
    # retry-free wait-class like flat colibri; woken heads are popped, so
    # queue_depth counts the sleepers only
    contract = Contract(exclusive_grant=True, wait_class=True,
                        retry_free=True, queue_counts_holder=False,
                        max_hot_scatters=12)
    kernel_code = KERNEL_HIER
