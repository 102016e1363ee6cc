"""``engine_run_kernel``'s fault instance, its own source on the CPU,
against the plain loop.

See ``tests/engine_mock.py`` for the build and the comparison: every key
of the result (``kmask``, ``kleft``, ``wd_srv``, ``wd_own``,
``last_ret``, ``halt_cyc``, ``faults_injected``, ``recoveries`` and
``dead_mask`` included) must equal ``_simulate_plain``'s.  One case per
recovery family (the FIFO queue, nb_feb's bit, lrsc's reservation, the
spin lock, the ticket lock, the two-level queues with and without the
turn budget) under a holder kill, request and wakeup drops and a bank
stall; a uniform kill with a stall window and traces; a holder kill
among many grants a cycle; a lock timed out in the cycle its holder is
killed; the two-cores-a-thread layout; and one
launch of two plans and the empty plan, blocks in index and reversed
order, whose fault-free block keeps the keys of a run without faults.
Skips without g++.
"""
import pytest

from engine_mock import TRACED, check, check_batch, mock_library  # noqa: F401

#: a holder kill, request and wakeup drops, a bank stall, the watchdog
MIXED = dict(n_kill=2, kill_cyc=40, watchdog_cyc=16, msg_drop_bp=300,
             n_bank_stall=1, bank_stall_cyc=60, bank_stall_dur=40,
             progress_cyc=80)
CASES = (
    [pytest.param(dict(protocol=pr, n_cores=32, n_addrs=3, cycles=300,
                       seed=i, faults=MIXED, **TRACED), id=f"{pr}/mixed")
     for i, pr in enumerate(("colibri", "nb_feb", "lrsc", "amo_lock",
                             "ticket_lock", "colibri_hier", "hw_event"))]
    + [pytest.param(dict(protocol="lrscwait", n_cores=48, n_addrs=2,
                         cycles=300, seed=7, n_workers=4, net_bw=13,
                         faults=dict(n_kill=3, kill_cyc=50, kill_holder=0,
                                     n_stall=4, stall_cyc=30, stall_dur=200,
                                     watchdog_cyc=24, progress_cyc=60),
                         **TRACED),
                    id="lrscwait/uniform-kill-stall-spans"),
       # a one-cycle watchdog times a lock out in the cycle it is granted,
       # so it reads the kill flag of a holder killed in that cycle (by a
       # thread of another warp): the barrier between the two stages
       pytest.param(dict(protocol="amo_lock", n_cores=96, n_addrs=2,
                         cycles=400, seed=0, backoff=0, lat=1, work=2,
                         faults=dict(n_kill=12, kill_cyc=30, watchdog_cyc=1,
                                     progress_cyc=100)),
                    id="amo_lock/killed-holder-times-out"),
       pytest.param(dict(protocol="lrsc", n_cores=64, n_addrs=16,
                         cycles=200, seed=8,
                         faults=dict(n_kill=2, kill_cyc=60,
                                     watchdog_cyc=12)),
                    id="lrsc/kill-order"),
       pytest.param(dict(protocol="mwait_lock", n_cores=1100, n_addrs=4,
                         cycles=60, seed=9, telemetry_windows=3,
                         faults=dict(MIXED, kill_cyc=10,
                                     bank_stall_cyc=20)),
                    id="mwait_lock/two-cores-a-thread")])

#: one launch: two plans and the empty plan
BATCH = [
    dict(protocol="colibri", n_cores=32, n_addrs=2, cycles=250, seed=1,
         faults=MIXED),
    dict(protocol="amo", n_cores=32, n_addrs=5, cycles=200, seed=2),
    dict(protocol="ticket_lock", n_cores=32, n_addrs=3, cycles=220, seed=3,
         faults=dict(n_kill=2, kill_cyc=30, watchdog_cyc=20,
                     progress_cyc=50), record_trace=True)]


@pytest.mark.parametrize("kw", CASES)
def test_fault_instance_on_the_cpu_equals_the_plain_loop(kw, mock_library,
                                                         tmp_path):
    assert check(mock_library, tmp_path, kw) == []


@pytest.mark.parametrize("order", [0, 1], ids=["index", "reversed"])
def test_launch_of_plans_and_the_empty_plan(order, mock_library, tmp_path):
    from repro_torch.core.sweep import _bucket_a
    banks = [_bucket_a(kw["n_addrs"]) for kw in BATCH]
    assert check_batch(mock_library, tmp_path, BATCH, banks,
                       order) == [[]] * len(BATCH)


def test_fault_launch_variant_and_words():
    """A launch with a plan takes the fault instance, one without keeps
    its own; the plan's words and masks are the plain loop's (the bank
    stall drawn over the banks allocated)."""
    from repro_torch.core import protocols, sim, workloads
    from repro_torch.kernels.engine_step import kernel as K

    def scalars(banks=None, **kw):
        p = sim.SimParams(**kw)
        return K.run_scalars(p, protocols.get(p.protocol),
                             workloads.get(p.workload).program(p), banks)

    flat = scalars(protocol="colibri", n_cores=32)
    c2 = scalars(protocol="colibri", n_cores=32, topology="cluster2")
    plan = dict(n_kill=40, kill_cyc=5, watchdog_cyc=8, n_bank_stall=9,
                bank_stall_cyc=3, bank_stall_dur=4, fault_seed=3)
    f = scalars(protocol="ticket_lock", n_cores=32, n_addrs=3, faults=plan)
    amo = scalars(protocol="amo", n_cores=32, faults=plan)
    assert K.launch_variant([flat, c2]) == K.INSTANCE_TOPO
    assert K.launch_variant([flat, c2, f]) == K.INSTANCE_FAULT
    assert flat["f_flags"] == 0 and flat["fault_masks"] is None
    assert f["f_flags"] == K.F_ON | K.F_HOLDER | K.F_BSTALL | K.F_WD
    assert amo["f_flags"] & K.F_WD == 0           # amo holds nothing
    assert (f["n_kill"], f["n_kill_eff"], f["n_bstall_eff"]) == (40, 32, 3)
    assert f["prog_thr"] == 2000 and f["bstall_end"] == 7
    assert f["drop_salt"] == 3 * 977 + 13
    fp = sim.SimParams(faults=plan).faults
    bucket = scalars(banks=4, protocol="ticket_lock", n_cores=32,
                     n_addrs=3, faults=plan)
    assert bucket["n_bstall_eff"] == 4
    assert bucket["fault_masks"][64:].tolist() == \
        fp.bank_stall_mask(4).astype(int).tolist()
    assert f["fault_masks"][64:].tolist() == \
        fp.bank_stall_mask(3).astype(int).tolist()
    words = K._pack_params(dict(f, drop_salt=2**32 - 1))
    assert len(words) == K.N_PARAM_WORDS and words[-4] == -1
