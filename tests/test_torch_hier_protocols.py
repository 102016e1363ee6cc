"""The port's last three protocols against the reference, bit for bit:
the two-level queues of ``colibri_hier`` (with its turn budget) and
``hw_event`` (without one), and ``nb_feb``'s full/empty bit in front of
its waiter FIFO.

At every point of ``tests/lock_points.py`` the port's result equals the
reference's on every key (``lqbuf``, ``ggq``, ``g_inq``, ... included),
and ``colibri_hier``'s does at group counts 1, 3 (which do not divide
the cores: the last group is larger), 8 and 64 (a group a core); both
are retry-free (no poll, ever).  Here too: the three protocols' kernel
families and ``kernel_args``.  ``nb_feb``'s points are in
``tests/test_torch_nb_feb.py`` and the reference's ``test_colibri_hier_*``
invariants, run on the port, in ``tests/test_torch_hier_invariants.py``
(three files, so that ``pytest --dist loadfile`` spreads them).
"""
import pytest

from lock_points import assert_execute_matches_reference, cases
from repro_torch.core import protocols as tprotocols
from repro_torch.core.protocols.base import (KERNEL_EVENT, KERNEL_FEB,
                                             KERNEL_HIER, MSGS_EVENT,
                                             MSGS_HIER, MSGS_NONE,
                                             NEVER_FULL)
from repro_torch.core.sim import SimParams
from jax_cache import release_compiled  # noqa: F401

PROTOS = ("colibri_hier", "hw_event", "nb_feb")


@pytest.mark.parametrize("proto,kw", cases(PROTOS[:2]))
def test_execute_matches_reference_key_for_key(proto, kw):
    got = assert_execute_matches_reference(proto, kw)
    assert got["ops"].sum() > 0
    assert int(got["polls"]) == 0                  # retry-free
    # the sleepers sit in the local queues' live slots only
    g = got["ggq"].shape[1]
    assert got["lqlen"].reshape(-1, g).sum(axis=1).max() <= kw["n_cores"]


@pytest.mark.parametrize("groups", [1, 3, 8, 64])
def test_colibri_hier_group_counts_match_the_reference(groups):
    kw = dict(n_cores=64, n_addrs=2, cycles=1500, n_groups=groups,
              seed=groups, record_trace=groups == 3,
              telemetry_windows=8 if groups == 3 else 0)
    got = assert_execute_matches_reference("colibri_hier", kw)
    g, gsz, cap_l = tprotocols.get("colibri_hier")._geom(
        SimParams(**kw), 64)
    assert g == groups
    assert got["lqbuf"].shape == (2 * g, cap_l)
    assert got["ggq"].shape == got["g_inq"].shape == (2, g)
    if groups == 3:
        assert (gsz, cap_l) == (21, 22)            # the last group is larger
    assert int(got["polls"]) == 0


def test_kernel_families_and_arguments():
    p = SimParams(n_cores=64, lat=6, n_groups=3)
    ch, hw, nf = (tprotocols.get(k) for k in PROTOS)
    assert (ch.kernel_code, hw.kernel_code, nf.kernel_code) == (
        KERNEL_HIER, KERNEL_EVENT, KERNEL_FEB)
    for pr in (ch, hw, nf):
        assert pr.uses_queue and not pr.fixed_backoff
        assert pr.fused_core_fields == pr.fused_xset_fields == ()
        assert pr.contract.retry_free and pr.contract.wait_class
    # hand-off delay lat + 2 / lat + 1, local wake 2 / 1 cycles, the
    # groups' geometry; nb_feb: the queue's wake after lat, no rejection
    assert ch.kernel_args(p) == (8, MSGS_HIER, 6, 0, 3, 21, 22, 2)
    assert hw.kernel_args(p) == (7, MSGS_EVENT, 6, 0, 3, 21, 22, 1)
    assert nf.kernel_args(p) == (6, MSGS_NONE, 6, NEVER_FULL, 0, 0, 0, 0)
    assert nf.q_cap(p, 64) == 64
    # the two-level queues' sleepers, not the holder, make the depth
    assert not ch.contract.queue_counts_holder
    assert not hw.contract.queue_counts_holder
    assert nf.contract.queue_counts_holder
    bank = {k: set(pr.init_bank_state(p, 2, 64, 64, "cpu"))
            for k, pr in zip(PROTOS, (ch, hw, nf))}
    assert bank["colibri_hier"] - bank["hw_event"] == {"turn_srv"}
    assert bank["nb_feb"] == {"feb", "qbuf", "qhead", "qlen", "wake_tmr"}
