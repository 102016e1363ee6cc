"""The port's message-level Colibri model (``repro_torch.core.colibri``)
against the paper's correctness argument and against the reference's copy.

The four properties of ``tests/test_colibri_protocol.py`` (mutual
exclusion and exactly-once service under LRSCwait, the Mwait chain drain,
the one-outstanding-LRwait rule, the SuccessorUpdate/SCwait bounce) run on
the port's ``ColibriSystem`` over seeded schedules: numpy draws each
case's seed, ``random.Random(seed)`` picks every delivery.  No more cases
than the reference's hypothesis settings (60 / 40 / 30), so that they
also run where hypothesis is not installed.

The parity cases drive both copies with one schedule (each choice the
same index into the same list of actions) and compare everything they
log: the messages delivered, the LRwait arrival order, the grant and
SCwait order, the violations and the final queue state.  Both are plain
Python, so they must agree exactly.
"""
from __future__ import annotations

import random

import numpy as np
import pytest

from repro.core import colibri as J
from repro_torch.core import colibri as T

#: seeds of each property, drawn once from numpy
SEEDS = np.random.default_rng(2026).integers(0, 2 ** 32 - 1, 64).tolist()


def drive(system, n_cores: int, ops_per_core: int, rng, log=None):
    """The reference test's schedule loop: each core performs
    ``ops_per_core`` LRSCwait pairs; ``rng`` picks among issuing an
    LRwait, an SCwait of a core holding its grant, or delivering the
    oldest message of a channel.  With ``log``, each delivered message is
    appended to it."""
    remaining = {c: ops_per_core for c in range(n_cores)}
    sc_pending = []
    base = 0
    while True:
        actions = []
        if not system.mwait:
            sc_pending.extend(system.responses[base:])
            base = len(system.responses)
        for c in range(n_cores):
            if remaining[c] > 0 and not system.outstanding.get(c):
                actions.append(("lr", c))
        actions.extend(("sc", c) for c in list(sc_pending))
        actions.extend(("deliver", ch) for ch in system.pending_channels())
        if not actions:
            return
        kind, arg = rng.choice(actions)
        if kind == "lr":
            system.core_issue_lrwait(arg)
            remaining[arg] -= 1
        elif kind == "sc":
            sc_pending.remove(arg)
            system.core_issue_scwait(arg)
        else:
            if log is not None:
                m = system.channels[arg][0]
                log.append((m.kind, m.src, m.dst, m.core, m.succ, m.value))
            system.deliver(arg)


@pytest.mark.parametrize("i", range(24))
def test_lrscwait_invariants(i):
    rng = random.Random(SEEDS[i])
    n_cores, ops = rng.randint(2, 8), rng.randint(1, 4)
    system = T.ColibriSystem(n_cores)
    drive(system, n_cores, ops, rng)
    system.check_final(expected_ops=n_cores * ops)
    assert len(system.sc_ok) == n_cores * ops


@pytest.mark.parametrize("i", range(12))
def test_mwait_chain_drain(i):
    """All Mwait waiters are woken by a single store, in FIFO order, with
    no action of the cores (paper §IV-B)."""
    rng = random.Random(SEEDS[24 + i])
    n_cores = rng.randint(2, 8)
    system = T.ColibriSystem(n_cores, mwait=True)
    for c in range(n_cores):
        system.core_issue_lrwait(c)
    while system.pending_channels():
        system.deliver(rng.choice(system.pending_channels()))
    assert system.responses == []
    system.store(42)
    while system.pending_channels():
        system.deliver(rng.choice(system.pending_channels()))
    assert system.responses == system.lr_arrival_order
    assert len(system.responses) == n_cores
    assert system.head is None and system.tail is None
    assert not system.violations, system.violations


def test_double_lrwait_rejected():
    system = T.ColibriSystem(2)
    system.core_issue_lrwait(0)
    with pytest.raises(AssertionError):
        system.core_issue_lrwait(0)


@pytest.mark.parametrize("i", range(8))
def test_successor_update_bounce(i):
    """B enqueues behind A, and A's SCwait passes its Qnode before the
    SuccessorUpdate arrives: the update bounces back as a WakeUpRequest
    and B is still served."""
    system = T.ColibriSystem(2)
    system.core_issue_lrwait(0)
    system.deliver(("core:0", "mem"))
    system.deliver(("mem", "core:0"))
    system.core_issue_lrwait(1)
    system.deliver(("core:1", "mem"))
    system.core_issue_scwait(0)
    rng = random.Random(SEEDS[36 + i])
    while system.pending_channels():
        system.deliver(rng.choice(system.pending_channels()))
    assert system.responses == [0, 1]
    system.core_issue_scwait(1)
    while system.pending_channels():
        system.deliver(rng.choice(system.pending_channels()))
    system.check_final(expected_ops=2)


def _state(system) -> dict:
    return dict(head=system.head, tail=system.tail,
                reservation=system.reservation, holder=system.holder,
                head_valid=system.head_valid, value=system.value,
                arrivals=system.lr_arrival_order, grants=system.responses,
                sc_ok=system.sc_ok, violations=system.violations,
                outstanding=dict(system.outstanding),
                quiescent=system.quiescent())


@pytest.mark.parametrize("mwait", [False, True])
@pytest.mark.parametrize("i", range(4))
def test_same_schedule_same_log_as_the_reference(i, mwait):
    """One seeded schedule through both copies: the same messages in the
    same order, the same grants, the same final state."""
    seed = SEEDS[44 + i]
    n_cores, ops = 3 + i, 1 + i % 3
    logs, states = [], []
    for mod in (J, T):
        system = mod.ColibriSystem(n_cores, mwait=mwait)
        log = []
        rng = random.Random(seed)
        if mwait:
            for c in range(n_cores):
                system.core_issue_lrwait(c)
            while system.pending_channels():
                ch = rng.choice(system.pending_channels())
                m = system.channels[ch][0]
                log.append((m.kind, m.src, m.dst, m.core, m.succ, m.value))
                system.deliver(ch)
            system.store(7)
            while system.pending_channels():
                ch = rng.choice(system.pending_channels())
                m = system.channels[ch][0]
                log.append((m.kind, m.src, m.dst, m.core, m.succ, m.value))
                system.deliver(ch)
        else:
            drive(system, n_cores, ops, rng, log)
            system.check_final(expected_ops=n_cores * ops)
        logs.append(log)
        states.append(_state(system))
    assert logs[0] and logs[0] == logs[1]
    assert states[0] == states[1]
