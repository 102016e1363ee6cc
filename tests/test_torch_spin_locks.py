"""The port's test&set spin locks (``amo_lock``, ``lrsc_lock``) against
the reference, bit for bit.

At every point of ``tests/lock_points.py`` the port's result equals the
reference's on every key.  Beside that: ``lrsc_lock``'s acquire answers
after two round trips and bills two side messages, ``amo_lock``'s after
one, and a release after one for both (the per-outcome timer the CUDA
kernels take from ``kernel_args``).
"""
import pytest
import torch

from lock_points import assert_execute_matches_reference, cases
from repro_torch.core import protocols as tprotocols
from repro_torch.core.protocols.base import (KERNEL_LOCK, MSGS_ACQ,
                                             MSGS_NONE, OUT_DONE, OUT_FAIL,
                                             OUT_GRANT, OUT_NONE, FusedCtx)
from repro_torch.core.sim import SimParams
from repro_torch.kernels.engine_step.ref import _param_ns


@pytest.mark.parametrize("proto,kw", cases(("amo_lock", "lrsc_lock")))
def test_execute_matches_reference_key_for_key(proto, kw):
    got = assert_execute_matches_reference(proto, kw)
    assert "lock" in got and got["ops"].sum() > 0


@pytest.mark.parametrize("proto,pair", [("amo_lock", False),
                                        ("lrsc_lock", True)])
def test_acquire_timer_and_messages_follow_the_pair(proto, pair):
    pr = tprotocols.get(proto)
    p = SimParams(protocol=proto, n_cores=8, n_addrs=4, lat=7)
    assert pr.kernel_code == KERNEL_LOCK and pr.fixed_backoff
    assert pr.kernel_args(p) == (0, MSGS_ACQ if pair else MSGS_NONE,
                                 14 if pair else 7, 0, 0, 0, 0, 0)
    # banks: free + acquire, held + acquire, held + release, no winner
    bank = dict(lock=torch.tensor([False, True, True, False]))
    fx = FusedCtx(p=_param_ns(p, 7), n=8, a=4, q_cap=8,
                  win=torch.tensor([3, 5, 1, 8], dtype=torch.int32),
                  acq_b=torch.tensor([True, True, False, False]),
                  rel_b=torch.tensor([False, False, True, False]))
    bank, fo = pr.fused_access(fx, bank)
    assert fo.kind.tolist() == [OUT_GRANT, OUT_FAIL, OUT_DONE, OUT_NONE]
    rt = 14 if pair else 7
    assert fo.tmr.tolist() == [rt, rt, 7, 7]
    assert bank["lock"].tolist() == [True, True, False, False]
    if pair:
        assert fo.msgs.tolist() == [2, 2, 0, 0]
    else:
        assert fo.msgs is None
