"""Protocol plugin interface for the cycle-level engine (``core.sim``).

PyTorch twin of the reference ABI.  The engine owns everything
protocol-agnostic: per-core timers and state transitions, the backoff
policy, worker traffic, network acceptance with head-of-line blocking,
and per-bank FIFO arbitration.  A ``Protocol`` owns only what happens
when an arbitrated request reaches its bank:

* ``init_bank_state``  — the per-bank dict of tensors (reservation
  slots, queues, ...) carried from cycle to cycle.
* ``init_core_state``  — optional per-core protocol state.
* ``on_access``        — the masked-update form of this cycle's bank
  winners (at most one per bank): the per-core writes done directly over
  the ``(n,)`` core arrays, split into acquire (``ctx.is_acq``) and
  release (``ctx.is_rel``) lanes, as the reference's engine runs it.
* ``fused_access``     — the bank-centric update of this cycle's bank
  winners, with per-core effects returned as ``OUT_*`` outcome codes.
  It is the plain form of the ``engine_step`` kernel's protocol stage.
* ``on_wake``          — queue-based protocols: fire wake-up timers and
  move sleeping cores back to their critical section.

* ``held`` / ``on_timeout`` — fault recovery: which banks are held
  (a dead owner wedges them), and the reservation watchdog's action on
  a bank held with no progress (evict a dead owner, re-send a lost
  wakeup, force-free a wedged lock).

The engine drives every protocol through ``fused_access`` only.
``on_access`` exists for the static analyses (``repro_torch.analysis``):
the model checker holds ``fused_access`` (and the ``engine_step`` kernel
in its place) to it on every reachable state of small configurations.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

# core states (BARWAIT: parked at a workload barrier, polling-free)
WORK, REQ, SLEEP, MOD, BACKOFF, RESP, BARWAIT = 0, 1, 2, 3, 4, 5, 6
# request phases
P_ACQ, P_REL = 0, 1
# resp_next codes
NXT_WORK_DONE, NXT_MOD, NXT_BACKOFF = 0, 1, 2

# per-bank outcome codes emitted by ``fused_access``: what happens to
# this bank's winning core.  The engine maps them onto per-core (st, nxt)
# writes — OUT_GRANT -> RESP/NXT_MOD, OUT_DONE -> RESP/NXT_WORK_DONE (and
# one latency-histogram sample), OUT_FAIL -> RESP/NXT_BACKOFF (and one
# poll), OUT_SLEEP -> SLEEP with the timer untouched, OUT_NONE -> no
# winner / no core-side effect.
OUT_NONE, OUT_GRANT, OUT_DONE, OUT_FAIL, OUT_SLEEP = 0, 1, 2, 3, 4
# recovery outcome codes emitted by ``on_timeout`` (the reservation
# watchdog): the bank's dead owner was evicted, or its lost wakeup was
# re-sent
OUT_EVICT, OUT_REDELIVER = 5, 6

#: ``Protocol.kernel_code`` values: which bank-update branch of the CUDA
#: ``engine_step`` kernel implements a protocol's ``fused_access`` (amo;
#: lrsc's reservation slot; the FIFO queue of lrscwait, colibri and
#: mwait_lock; the test&set lock bit of amo_lock and lrsc_lock; the ticket
#: dispenser of ticket_lock; the two-level queues of colibri_hier, with
#: its turn budget, and of hw_event, without one (one branch, two bank
#: layouts); the FIFO queue behind nb_feb's full/empty bit)
(KERNEL_AMO, KERNEL_LRSC, KERNEL_QUEUE, KERNEL_LOCK, KERNEL_TICKET,
 KERNEL_HIER, KERNEL_EVENT, KERNEL_FEB) = range(8)
#: side-message rules of the kernel's branches (``kernel_args``): messages
#: beyond the engine's 2 per winner.  None; colibri's SuccessorUpdate and
#: WakeUpRequest round trips, 2 * (enqueued + pending wake); mwait_lock's
#: Mwait setup, 2 * enqueued; lrsc_lock's LR/SC pair, 2 * acquire;
#: colibri_hier's, 1 per enqueue, 2 per group registration, 1 per local
#: wake, 2 per re-registration and 2 per cross-group hand-off; hw_event's,
#: 1 per registration and 2 per hand-off
MSGS_NONE, MSGS_ENQ_PEND, MSGS_ENQ, MSGS_ACQ, MSGS_HIER, MSGS_EVENT = \
    range(6)
#: ``kernel_args``' queue length of a queue that never rejects (int32 max)
NEVER_FULL = 2**31 - 1


class KernelArgs(NamedTuple):
    """The scalars a protocol's branch of the CUDA kernels reads
    (:meth:`Protocol.kernel_args`)."""
    #: the queue's wake delay (0 without a queue); the two-level queues'
    #: cross-group hand-off delay
    wake_delay: int = 0
    #: the side-message rule (``MSGS_*``)
    msg_rule: int = MSGS_NONE
    #: the response timer of an acquire's outcome (every other outcome
    #: answers after ``p.lat``)
    acq_tmr: int = 0
    #: the queue length at which an acquire is rejected (0 without a
    #: queue, ``NEVER_FULL`` for a queue that never rejects)
    q_full: int = 0
    #: the two-level queues: groups, cores a group (the last group takes
    #: the rest), slots of a group's local queue, and the local wake
    #: delay; 0 for the other families
    groups: int = 0
    group_size: int = 0
    group_cap: int = 0
    local_delay: int = 0


@dataclasses.dataclass(frozen=True)
class Contract:
    """Machine-checkable protocol contract (the reference's static
    analyses read it; the port keeps the declarations as they are)."""
    #: OUT_GRANT (or a wake) hands EXCLUSIVE ownership
    exclusive_grant: bool = True
    #: retry-free: OUT_FAIL is unreachable when queues are sized for
    #: the core count
    retry_free: bool = False
    #: wait-class: contenders are parked with OUT_SLEEP and woken by the
    #: protocol instead of polling via OUT_FAIL
    wait_class: bool = False
    #: OUT_FAIL is legal ONLY when the bank's queue is full
    fail_requires_full: bool = False
    #: the watchdog may act on a bank whose owner is live
    evict_live_safe: bool = False
    #: ``queue_depth`` counts the current holder as well as the sleepers
    queue_counts_holder: bool = True
    #: scatter-family ops allowed in the reference's hot scan body
    max_hot_scatters: int = 0


@dataclasses.dataclass
class Ctx:
    """Per-cycle view handed to :meth:`Protocol.on_access`,
    :meth:`Protocol.on_wake` and :meth:`Protocol.on_timeout`.

    The masked-update lanes (``is_acq`` ... ``rel_b``) are what
    ``on_access`` reads; the engine, which runs only the fused form,
    leaves them ``None``.
    """
    p: Any                   # resolved SimParams-like namespace
    n: int                   # cores
    a: int                   # banks allocated
    q_cap: int               # queue slots per bank
    is_acq: Optional[torch.Tensor] = None   # (n,) bool acquire winners
    is_rel: Optional[torch.Tensor] = None   # (n,) bool release winners
    wa: Optional[torch.Tensor] = None       # (n,) int32 each core's bank
    wc: Optional[torch.Tensor] = None       # (n,) int32 core ids
    ba: Optional[torch.Tensor] = None       # (a,) int32 bank ids
    #: (a,) int32: each bank's winning core, or ``n`` without one (at
    #: most one winner a bank, so bank state updates are dense; gather
    #: core values at ``win_core.clamp(max=n - 1)``)
    win_core: Optional[torch.Tensor] = None
    acq_b: Optional[torch.Tensor] = None    # (a,) bool winner acquires
    rel_b: Optional[torch.Tensor] = None    # (a,) bool winner releases
    #: (n,) int32: each core's current micro-op's modify duration
    #: (cycles), the step table's entry at its program counter; wake
    #: paths grant with it
    mod_dur: Optional[torch.Tensor] = None


@dataclasses.dataclass
class FusedCtx:
    """Bank-centric view handed to :meth:`Protocol.fused_access`.

    Everything is dense over the ``a`` banks: there are no ``(n,)``
    core arrays to write — per-core effects are *returned* as outcome
    codes and applied by the engine.  ``core`` holds the values of the
    protocol's ``fused_core_fields`` gathered at the winning core.
    """
    p: Any                   # resolved params namespace (lat, ...)
    n: int                   # cores
    a: int                   # banks
    q_cap: int               # queue slots per bank
    win: torch.Tensor        # (a,) int32 winning core id, or n if none
    acq_b: torch.Tensor      # (a,) bool — winner is an acquire
    rel_b: torch.Tensor      # (a,) bool — winner is a release
    core: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FusedOut:
    """Per-bank outputs of :meth:`Protocol.fused_access`: ``kind`` (the
    ``OUT_*`` code), ``tmr`` (response timer for RESP kinds), ``msgs``
    (protocol side-messages beyond the engine's 2-per-winner, or None)
    and ``xset`` (per-core writes as ``(values, mask)`` pairs)."""
    kind: torch.Tensor
    tmr: torch.Tensor
    msgs: Optional[torch.Tensor] = None
    xset: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict)


class Protocol:
    """Base protocol plugin. Subclasses override the hooks they need."""

    name: str = ""
    contract: Contract = Contract()
    #: queue-based protocols get the engine's wake pass and their wake-up
    #: responses counted against next cycle's network budget.
    uses_queue: bool = False
    #: lock-style protocols use the paper's FIXED backoff (exp cap 1).
    fixed_backoff: bool = False
    #: per-core state fields ``fused_access`` needs gathered at the winner
    fused_core_fields: Tuple[str, ...] = ()
    #: per-core state fields ``fused_access`` may write via ``xset``
    fused_xset_fields: Tuple[str, ...] = ()
    #: bank-update branch of the CUDA ``engine_step`` kernel (KERNEL_*),
    #: or None when the kernel has no branch for this protocol
    kernel_code: Optional[int] = None

    # ---- static sizing ----
    def q_cap(self, p, n: int) -> int:
        """Queue slots per bank. Default: one per core."""
        return n

    # ---- state ----
    def init_bank_state(self, p, a: int, n: int, q_cap: int,
                        device) -> Dict[str, torch.Tensor]:
        return {}

    def queue_depth(self, bank: Dict) -> Optional[torch.Tensor]:
        """(a,) per-bank reservation-queue occupancy, or ``None`` for
        queueless protocols; the engine's telemetry and trace read it
        once per cycle.  Default: the single FIFO queue's ``qlen``."""
        return bank.get("qlen")

    def init_core_state(self, p, n: int, device) -> Dict[str, torch.Tensor]:
        return {}

    # ---- handlers ----
    def on_access(self, ctx: Ctx, cs: Dict, bank: Dict
                  ) -> Tuple[Dict, Dict]:
        """Masked-update form of this cycle's bank winners: write the
        winners' ``cs`` lanes (``st``/``tmr``/``nxt``, the 0-d ``polls``
        and ``msgs`` counters, the protocol's per-core state) and the
        bank state directly; return ``(cs, bank)``.  Must equal the
        reference protocol's ``on_access`` bit for bit, and
        :meth:`fused_access` plus the engine's outcome apply."""
        raise NotImplementedError(
            f"protocol {self.name!r} does not provide on_access")

    def fused_access(self, fx: FusedCtx, bank: Dict
                     ) -> Tuple[Dict, FusedOut]:
        """Dense bank update of this cycle's winners; must equal the
        reference protocol's ``fused_access`` bit for bit."""
        raise NotImplementedError(
            f"protocol {self.name!r} does not provide fused_access")

    def kernel_args(self, p) -> KernelArgs:
        """The scalars of the CUDA kernel's branch (:class:`KernelArgs`)
        for the resolved parameters ``p``, whose ``n_cores`` is the run's
        core count.  Default: no queue, no side messages."""
        return KernelArgs(acq_tmr=p.lat)

    def on_wake(self, ctx: Ctx, cs: Dict, bank: Dict
                ) -> Tuple[Dict, Dict, torch.Tensor]:
        """Fire wake-up timers; return (cs, bank, wake_load) where
        ``wake_load`` is the number of wake responses that occupy
        network slots next cycle.  Default: a single FIFO queue per bank
        (lrscwait / colibri)."""
        wake_tmr = bank["wake_tmr"]
        fire = wake_tmr == 1
        wake_tmr = (wake_tmr - 1).clamp_(min=0)
        ba = ctx.ba if ctx.ba is not None else torch.arange(
            ctx.a, dtype=torch.int32, device=wake_tmr.device)
        head_core = bank["qbuf"][ba, bank["qhead"]]
        # wake the head core of each firing queue; non-firing banks
        # write slot n of an (n+1)-long mask, which is then cut off
        fire_core = head_core.masked_fill(~(fire & (bank["qlen"] > 0)),
                                          ctx.n)
        woken = torch.zeros((ctx.n + 1,), dtype=torch.bool,
                            device=wake_tmr.device)
        woken[fire_core] = True
        woken = woken[:ctx.n]
        cs["st"] = cs["st"].masked_fill(woken, MOD)
        cs["tmr"] = torch.where(woken, ctx.mod_dur, cs["tmr"])
        bank["wake_tmr"] = wake_tmr
        return cs, bank, (wake_tmr == 1).sum(dtype=torch.int32)

    # ---- fault recovery (repro_torch.faults) ----------------------------
    def held(self, bank: Dict) -> Optional[torch.Tensor]:
        """(a,) bool: which banks are currently *held* (a reservation,
        lock or turn is outstanding, so a dead owner wedges the bank).
        ``None`` (the default) means the protocol has no held state and
        can never get stuck: the engine then runs no watchdog at all
        (amo: every access commits at the bank)."""
        return None

    def on_timeout(self, ctx: Ctx, cs: Dict, bank: Dict,
                   stuck_b: torch.Tensor, killed: torch.Tensor,
                   owner: torch.Tensor
                   ) -> Tuple[Dict, Dict, torch.Tensor]:
        """Reservation-watchdog recovery, once a cycle while the plan
        arms ``watchdog_cyc``: ``stuck_b`` (a,) are the banks held with
        no service progress for ``watchdog_cyc`` cycles, ``killed`` (n,)
        the permanently killed cores and ``owner`` (a,) the engine's
        last grantee of each bank (``n``: unknown).  Returns ``(cs,
        bank, kind)``: ``cs["msgs"]`` grown by the recovery's messages,
        and ``kind`` (a,) an ``OUT_EVICT`` / ``OUT_REDELIVER`` /
        ``OUT_NONE`` code per bank.  Default: no recovery."""
        return cs, bank, torch.zeros((ctx.a,), dtype=torch.int32,
                                     device=stuck_b.device)


def respond(cs: Dict, mask: torch.Tensor, tmr, nxt) -> None:
    """``on_access``'s answer to the cores of ``mask``: state RESP, timer
    ``tmr`` and next state ``nxt`` (ints or (n,) int32 tensors)."""
    cs["st"] = cs["st"].masked_fill(mask, RESP)
    cs["tmr"] = torch.where(mask, tmr, cs["tmr"])
    cs["nxt"] = torch.where(mask, nxt, cs["nxt"])


def enqueue(qbuf: torch.Tensor, put_b: torch.Tensor, qhead: torch.Tensor,
            qlen: torch.Tensor, win: torch.Tensor, q_cap: int
            ) -> torch.Tensor:
    """``qbuf`` (a, slots) with each bank of ``put_b`` holding its winner
    ``win`` in slot ``(qhead + qlen) % q_cap`` (a masked write: the other
    banks keep the slot's old value)."""
    slot_b = torch.remainder(qhead + qlen, q_cap)
    ba = torch.arange(qbuf.shape[0], device=qbuf.device)
    qbuf = qbuf.clone()
    qbuf[ba, slot_b] = torch.where(put_b, win, qbuf[ba, slot_b])
    return qbuf


def count(mask: torch.Tensor) -> torch.Tensor:
    """0-d int32 number of set lanes (a counter's increment)."""
    return mask.sum(dtype=torch.int32)


def _owner_dead(killed: torch.Tensor, owner: torch.Tensor, n: int):
    """(a,) bool: the bank's recorded owner is known and killed."""
    return (owner < n) & killed[owner.clamp(0, n - 1)]


class FifoQueueRecovery:
    """``held``/``on_timeout`` of the single-FIFO sleep protocols
    (lrscwait, colibri, mwait_lock, nb_feb), where the queue head IS the
    current owner: a stuck bank whose head core is permanently dead is
    evicted (the head advances; the reservation passes to the next
    waiter through a normal wake), and a stuck bank whose head is alive
    had its wakeup lost: it is re-sent.  A mixin over :class:`Protocol`
    subclasses with ``qbuf``/``qhead``/``qlen``/``wake_tmr`` bank state
    and a ``wake_delay(p)`` policy."""

    def held(self, bank):
        return bank["qlen"] > 0

    def on_timeout(self, ctx, cs, bank, stuck_b, killed, owner):
        q_cap, n = ctx.q_cap, ctx.n
        qhead, qlen = bank["qhead"], bank["qlen"]
        head = bank["qbuf"][ctx.ba, qhead]
        head_dead = (head >= 0) & killed[head.clamp(0, n - 1)]
        evict_b = stuck_b & head_dead
        qhead = torch.where(evict_b, torch.remainder(qhead + 1, q_cap),
                            qhead)
        qlen = qlen - evict_b.to(torch.int32)
        redeliver_b = stuck_b & ~head_dead
        # hand the reservation to the new head / re-send the lost wake
        wake_b = (evict_b | redeliver_b) & (qlen > 0)
        wake_tmr = bank["wake_tmr"].masked_fill(wake_b,
                                                self.wake_delay(ctx.p))
        cs["msgs"] = cs["msgs"] + 2 * wake_b.sum(dtype=torch.int32)
        bank = dict(bank, qhead=qhead, qlen=qlen, wake_tmr=wake_tmr)
        kind = torch.where(evict_b, OUT_EVICT,
                           torch.where(redeliver_b & wake_b, OUT_REDELIVER,
                                       OUT_NONE)).to(torch.int32)
        return cs, bank, kind
