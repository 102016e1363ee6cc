"""Fault injection and recovery in the port against the reference.

``repro_torch.core.sim.execute`` on the CPU (the plain loop,
``_simulate_plain``) equals ``repro.core.sim.execute`` on every key —
``kmask``, ``kleft``, ``wd_srv``, ``wd_own``, ``last_ret``,
``dead_mask``, ``faults_injected``, ``recoveries``, ``halt_cyc`` and the
survivor metrics included — for every protocol under an owner kill with
and without the reservation watchdog, the mixed plan of
``tests/test_faults.py`` (holder kill, request and wakeup drops, a bank
stall), lost wakeups on the queue protocols, a uniform kill, stall
windows that close before the horizon and that span it, the automatic
progress threshold, more kills than cores, a workload program, a
hierarchical topology and a traced point with telemetry.  The result's
row and the Perfetto export of a traced fault point equal the
reference's, and a CPU ``Study`` draws its bank-stall victims over each
point's bank bucket, as the reference's sweep does.
"""
import hashlib
import json

import numpy as np
import pytest

import repro.sync as jsync
from lock_points import assert_execute_matches_reference
from repro.core.protocols import names as proto_names
from repro.obs import perfetto as jperfetto
from repro_torch import sync as tsync
from repro_torch.core import sim as tsim
from repro_torch.obs import perfetto as tperfetto
from jax_cache import release_compiled  # noqa: F401

BASE = dict(n_cores=32, n_addrs=4, cycles=1200, seed=1)
#: an adversarial owner kill, with and without the watchdog
KILL = dict(n_kill=2, kill_cyc=300, kill_holder=1, watchdog_cyc=64,
            progress_cyc=400)
NOWD = dict(KILL, watchdog_cyc=0)
#: tests/test_faults.py's full fault mix
MIXED = dict(n_kill=2, kill_cyc=200, kill_holder=1, watchdog_cyc=64,
             msg_drop_bp=150, n_bank_stall=1, bank_stall_cyc=400,
             bank_stall_dur=100)
QUEUES = ("lrscwait", "colibri", "mwait_lock", "nb_feb", "colibri_hier",
          "hw_event")


def _check(proto, faults, **kw):
    return assert_execute_matches_reference(
        proto, dict(BASE, **kw, faults=faults))


@pytest.mark.parametrize("watchdog", [True, False], ids=["wd", "nowd"])
@pytest.mark.parametrize("proto", proto_names())
def test_owner_kill_matches_reference(proto, watchdog):
    got = _check(proto, KILL if watchdog else NOWD)
    if proto == "amo":                        # nothing is ever held
        assert got["faults_injected"] == 0 and got["progress_ok"]
        assert "wd_own" not in got and got["recoveries"] == 0
        return
    assert got["faults_injected"] == 2 and int(got["dead_mask"].sum()) == 2
    assert int(got["kleft"]) == 0 and int(got["kmask"].sum()) == 2
    if watchdog:
        assert got["recoveries"] >= 1 and got["progress_ok"]
    else:
        assert got["recoveries"] == 0 and "wd_srv" not in got


@pytest.mark.parametrize("proto", ["lrscwait", "mwait_lock", "lrsc",
                                   "colibri_hier", "hw_event", "nb_feb",
                                   "ticket_lock"])
def test_mixed_plan_matches_reference(proto):
    got = _check(proto, MIXED)
    assert got["faults_injected"] > 2 and got["recoveries"] >= 1


@pytest.mark.parametrize("proto", QUEUES)
def test_lost_wakeups_match_reference(proto):
    got = _check(proto, dict(msg_drop_bp=300, watchdog_cyc=64,
                             progress_cyc=400))
    assert got["faults_injected"] > 0 and got["recoveries"] > 0
    assert got["progress_ok"]


@pytest.mark.parametrize("name,proto,faults,kw", [
    ("lost-wakeup-no-watchdog", "lrscwait",
     dict(msg_drop_bp=300, progress_cyc=300), {}),
    ("uniform-kill", "lrscwait",
     dict(n_kill=3, kill_cyc=150, kill_holder=0, watchdog_cyc=32), {}),
    ("uniform-kill-ticket", "ticket_lock",
     dict(n_kill=3, kill_cyc=150, kill_holder=0, watchdog_cyc=32), {}),
    ("stall-closes", "colibri",
     dict(n_stall=4, stall_cyc=100, stall_dur=200, watchdog_cyc=48), {}),
    ("stall-spans-horizon", "lrsc_lock",
     dict(n_stall=4, stall_cyc=900, stall_dur=500, watchdog_cyc=48), {}),
    ("auto-progress-threshold", "mwait_lock",
     dict(n_kill=1, kill_cyc=100, watchdog_cyc=600), {}),
    ("more-kills-than-cores", "colibri",
     dict(n_kill=40, kill_cyc=100, watchdog_cyc=32, progress_cyc=200), {}),
    ("more-uniform-kills-than-cores", "amo_lock",
     dict(n_kill=40, kill_cyc=100, kill_holder=0, progress_cyc=200), {}),
    # many banks: several grants a cycle, so the holder kill's victims
    # are chosen by core index among more candidates than kills left
    ("kill-order", "lrsc",
     dict(n_kill=2, kill_cyc=60, watchdog_cyc=24),
     dict(n_cores=64, n_addrs=16, cycles=600)),
    ("killed-holder-times-out", "amo_lock",
     dict(n_kill=12, kill_cyc=30, watchdog_cyc=1, progress_cyc=100),
     dict(n_cores=96, n_addrs=2, cycles=400, seed=0, backoff=0, lat=1,
          work=2)),
    ("workers", "colibri",
     dict(n_stall=6, stall_cyc=50, stall_dur=300, msg_drop_bp=200,
          watchdog_cyc=64), dict(n_workers=6, net_bw=13, hol_block=4)),
    ("program", "colibri_hier", MIXED,
     dict(workload="ms_queue", n_addrs=2)),
    ("cluster2", "lrscwait", MIXED,
     dict(topology="cluster2", clusters=4, net_bw=9)),
    ("traced", "nb_feb", dict(MIXED, n_stall=3, stall_cyc=50,
                              stall_dur=100),
     dict(cycles=600, record_trace=True, telemetry_windows=16)),
])
def test_edge_plans_match_reference(name, proto, faults, kw):
    got = _check(proto, faults, **kw)
    fp = tsim.SimParams(faults=faults).faults
    if name == "auto-progress-threshold":
        assert fp.progress_threshold() == 2400
    if name == "stall-spans-horizon":
        assert int(got["dead_mask"].sum()) == 4
    if name.startswith("more-"):
        assert int(got["dead_mask"].sum()) <= BASE["n_cores"]


def test_fault_free_plan_adds_no_key():
    """The empty plan (and one that arms nothing) keeps the result dict
    of a run without faults, key for key."""
    kw = dict(protocol="colibri", n_cores=16, n_addrs=2, cycles=200)
    plain = tsim.execute(tsim.SimParams(**kw), device="cpu")
    empty = tsim.execute(tsim.SimParams(**kw, faults={}), device="cpu")
    assert list(plain) == list(empty)
    for k in plain:
        assert np.array_equal(np.asarray(plain[k]), np.asarray(empty[k]))
    for k in ("dead_mask", "faults_injected", "halt_cyc", "progress_ok"):
        assert k not in plain


@pytest.mark.parametrize("proto", QUEUES)
def test_no_cycle_wakes_two_cores_of_one_bank(proto, monkeypatch):
    """``wd_own`` learns a woken core's bank by a scatter; it is exact
    only if no cycle wakes two cores of one bank, which holds for every
    queue protocol under kills, drops and watchdog recoveries."""
    real = tsim._scatter_at_wakes
    calls = []

    def checked(dst, woken, addr, vals):
        hits = np.bincount(addr[woken].numpy(), minlength=dst.shape[0])
        assert hits.max(initial=0) <= 1
        calls.append(int(woken.sum()))
        return real(dst, woken, addr, vals)

    monkeypatch.setattr(tsim, "_scatter_at_wakes", checked)
    fp = dict(n_kill=3, kill_cyc=100, watchdog_cyc=24, msg_drop_bp=500,
              n_stall=4, stall_cyc=50, stall_dur=150)
    tsim.execute(tsim.SimParams(protocol=proto, n_cores=32, n_addrs=2,
                                cycles=600, faults=fp), device="cpu")
    assert sum(calls) > 0


def test_result_row_and_perfetto_match_reference():
    """``derive_metrics``' fault keys, ``Result.to_row()`` and the
    Perfetto JSON (DEAD, STALL and BANK_STALL spans, the HALT instant)
    of a traced fault point equal the reference's, byte for byte."""
    spec = dict(protocol="lrscwait", n_cores=16, n_addrs=2, cycles=500,
                record_trace=True,
                faults=dict(n_kill=1, kill_cyc=80, n_stall=2, stall_cyc=40,
                            stall_dur=60, n_bank_stall=1,
                            bank_stall_cyc=30, bank_stall_dur=40,
                            progress_cyc=150))
    want = jsync.run(jsync.Spec(**spec))
    got = tsync.run(tsync.Spec(**spec), device="cpu")
    assert got.to_row() == want.to_row()
    assert got.progress_ok is want.progress_ok is False
    assert (got.faults_injected, got.recoveries) == \
        (want.faults_injected, want.recoveries)

    def sha(mod, r):
        ev = mod.to_trace_events(r)
        names = {e["name"] for e in ev if e.get("cat") == "fault"}
        assert names == {"DEAD", "STALL", "BANK_STALL", "HALT"}
        blob = json.dumps({"traceEvents": ev}, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    assert sha(tperfetto, got) == sha(jperfetto, want)


def test_study_draws_bank_stalls_over_the_bucket():
    """A swept point stalls banks drawn over its power-of-two bucket
    (n_addrs 3 -> 4, 5 -> 8), a single run over n_addrs: the CPU
    ``Study`` equals the reference's on every key, faulted and
    fault-free points in one grid."""
    base = dict(protocol="colibri", n_cores=32, cycles=600, seed=2)
    plans = ({}, dict(n_bank_stall=1, bank_stall_cyc=50,
                      bank_stall_dur=300, watchdog_cyc=32,
                      progress_cyc=200))

    def study(pkg):
        return pkg.Study(pkg.Spec(**base)).grid(n_addrs=(3, 5),
                                                faults=plans)

    want = study(jsync).run()
    got = study(tsync).run(device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.spec.to_dict() == w.spec.to_dict()
        assert set(g.stats) == set(w.stats)
        for k, v in w.stats.items():
            gv, wv = np.asarray(g.stats[k]), np.asarray(v)
            assert (gv.dtype, gv.shape) == (wv.dtype, wv.shape), k
            assert np.array_equal(gv, wv), k
        assert g.to_row() == w.to_row()
    # the bucket's draw differs from the single run's for these points
    single = tsim.SimParams(n_addrs=5, faults=plans[1]).faults
    assert not np.array_equal(single.bank_stall_mask(5),
                              single.bank_stall_mask(8)[:5])
    assert got[3].stats["qlen"].shape == (8,)
    assert got[3].faults_injected == 1 and got[2].faults_injected == 0
