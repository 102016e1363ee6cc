"""Protocol plugin interface for the cycle-level engine (``core.sim``).

PyTorch twin of the reference ABI.  The engine owns everything
protocol-agnostic: per-core timers and state transitions, the backoff
policy, worker traffic, network acceptance with head-of-line blocking,
and per-bank FIFO arbitration.  A ``Protocol`` owns only what happens
when an arbitrated request reaches its bank:

* ``init_bank_state``  — the per-bank dict of tensors (reservation
  slots, queues, ...) carried from cycle to cycle.
* ``init_core_state``  — optional per-core protocol state.
* ``fused_access``     — the bank-centric update of this cycle's bank
  winners, with per-core effects returned as ``OUT_*`` outcome codes.
  It is the plain form of the ``engine_step`` kernel's protocol stage.
* ``on_wake``          — queue-based protocols: fire wake-up timers and
  move sleeping cores back to their critical section.

The port drives every protocol through ``fused_access``; the masked
``on_access`` form (the reference's XLA scan path) and the fault hooks
(``held``/``on_timeout``) are not part of the port yet.
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
# recovery outcome codes of the reservation watchdog (kept so the code
# table matches the reference; the port has no watchdog yet)
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
    """Per-cycle view handed to :meth:`Protocol.on_wake`.

    The reference's ``Ctx`` also carries the masked-update lanes
    (``is_acq``, ``win_core``, ...) of its ``on_access`` form; the port
    runs only the fused form, so it carries what ``on_wake`` reads.
    """
    p: Any                   # resolved SimParams-like namespace
    n: int                   # cores
    a: int                   # banks allocated
    q_cap: int               # queue slots per bank
    ba: Optional[torch.Tensor] = None       # (a,) int32 bank ids
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
