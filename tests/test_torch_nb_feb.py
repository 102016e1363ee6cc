"""``nb_feb`` on the port against the reference, bit for bit: at every
point of ``tests/lock_points.py`` every key (``feb`` included) equals
``repro.core.sim.execute``'s, there is no poll (the FIFO holds one entry
a core, so no acquire is ever rejected), and the full/empty bit tracks
the queue, ``feb == (qlen == 0)``, at the end of every run (the
invariant the reference's model checker certifies).  Beside them: the
bank update on its own, from a state where the bit and the queue
disagree, as the card's kernel phase draws them.
"""
import numpy as np
import pytest
import torch

from lock_points import assert_execute_matches_reference, cases
from repro_torch.core import protocols as tprotocols
from repro_torch.core.protocols.base import (OUT_DONE, OUT_GRANT, OUT_NONE,
                                             OUT_SLEEP, FusedCtx)
from repro_torch.core.sim import SimParams
from repro_torch.kernels.engine_step.ref import _param_ns
from jax_cache import release_compiled  # noqa: F401


@pytest.mark.parametrize("proto,kw", cases(("nb_feb",)))
def test_execute_matches_reference_key_for_key(proto, kw):
    got = assert_execute_matches_reference(proto, kw)
    assert got["ops"].sum() > 0
    assert int(got["polls"]) == 0
    np.testing.assert_array_equal(got["feb"], got["qlen"] == 0)


def test_grant_reads_the_bit_not_the_queue():
    """Banks: full bit + empty queue + acquire (grant), empty bit + empty
    queue + acquire (sleep: the bit decides), full bit + one waiter +
    acquire (grant all the same), empty bit + two entries + release
    (hand-off: the bit stays empty), empty bit + one entry + release
    (drained: the bit fills), no winner."""
    pr = tprotocols.get("nb_feb")
    p = SimParams(protocol="nb_feb", n_cores=8, n_addrs=6, lat=5)
    bank = pr.init_bank_state(p, 6, 8, 8, "cpu")
    bank["feb"] = torch.tensor([True, False, True, False, False, True])
    bank["qlen"] = torch.tensor([0, 0, 1, 2, 1, 0], dtype=torch.int32)
    bank["qbuf"][2, 0] = 4
    bank["qbuf"][3, :2] = torch.tensor([1, 6])
    bank["qbuf"][4, 0] = 7
    fx = FusedCtx(p=_param_ns(p, 5), n=8, a=6, q_cap=8,
                  win=torch.tensor([0, 2, 3, 1, 7, 8], dtype=torch.int32),
                  acq_b=torch.tensor([True, True, True, False, False,
                                      False]),
                  rel_b=torch.tensor([False, False, False, True, True,
                                      False]))
    new, out = pr.fused_access(fx, bank)
    assert out.kind.tolist() == [OUT_GRANT, OUT_SLEEP, OUT_GRANT, OUT_DONE,
                                 OUT_DONE, OUT_NONE]
    assert new["feb"].tolist() == [False, False, False, False, True, True]
    assert new["qlen"].tolist() == [1, 1, 2, 1, 0, 0]
    assert new["qbuf"][0, 0] == 0 and new["qbuf"][1, 0] == 2
    assert new["qbuf"][2, 1] == 3                 # the grantee enqueued
    assert new["qhead"].tolist() == [0, 0, 0, 1, 1, 0]
    assert new["wake_tmr"].tolist() == [0, 0, 0, 5, 0, 0]
    assert out.msgs is None
