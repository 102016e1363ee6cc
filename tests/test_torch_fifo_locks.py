"""The port's FIFO locks (``ticket_lock``, ``mwait_lock``) against the
reference, bit for bit, and the ticket dispenser's FIFO invariant.

At every point of ``tests/lock_points.py`` the port's result equals the
reference's on every key, ``ticket_lock``'s per-core ``tkt`` included.
``ticket_lock`` grants strictly in draw order: per-core completed ops
stay within one ticket round of each other, unlike the random test&set
winner of ``amo_lock`` (the reference's
``tests/test_protocols.py::test_ticket_lock_fifo_fairness``, run on the
port).
"""
import pytest

from lock_points import assert_execute_matches_reference, cases
from repro_torch import sync as tsync
from repro_torch.core import protocols as tprotocols
from repro_torch.core.protocols.base import (KERNEL_QUEUE, KERNEL_TICKET,
                                             MSGS_ENQ, NEVER_FULL)
from repro_torch.core.sim import SimParams
from jax_cache import release_compiled  # noqa: F401


@pytest.mark.parametrize("proto,kw", cases(("ticket_lock", "mwait_lock")))
def test_execute_matches_reference_key_for_key(proto, kw):
    got = assert_execute_matches_reference(proto, kw)
    if proto == "ticket_lock":
        assert got["tkt"].shape == (kw["n_cores"],)
        assert got["tkt"].min() >= -1
    assert got["ops"].sum() > 0


def test_ticket_lock_fifo_fairness():
    kw = dict(n_addrs=1, n_cores=64, cycles=8000, backoff=128, backoff_exp=1)
    tkt = tsync.run(protocol="ticket_lock", device="cpu", **kw).stats
    amo = tsync.run(protocol="amo_lock", device="cpu", **kw).stats
    assert int(tkt["ops"].sum()) > 0
    assert int(tkt["polls"]) > 0                        # still a spin lock
    t_span = int(tkt["ops"].max()) - int(tkt["ops"].min())
    a_span = int(amo["ops"].max()) - int(amo["ops"].min())
    assert t_span <= 2                                  # FIFO service
    assert t_span < a_span                              # fairer than t&s
    # every ticket drawn is served or held: the dispenser is at most one
    # draw per core ahead of the serving counter
    assert 0 <= int(tkt["next_tkt"][0]) - int(tkt["serving"][0]) <= 64


def test_kernel_families_and_arguments():
    p = SimParams(n_cores=16, lat=6)
    tl, mw = tprotocols.get("ticket_lock"), tprotocols.get("mwait_lock")
    assert tl.kernel_code == KERNEL_TICKET
    assert tl.fused_core_fields == tl.fused_xset_fields == ("tkt",)
    assert mw.kernel_code == KERNEL_QUEUE and mw.uses_queue
    assert mw.q_cap(p, 16) == 16
    assert mw.kernel_args(p) == (8, MSGS_ENQ, 6, NEVER_FULL, 0, 0, 0, 0)
