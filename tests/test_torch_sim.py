"""The port's engine against the reference's, key for key.

``repro_torch.core.sim.execute`` on the CPU must return the same result
dict as ``repro.core.sim.execute``: the same keys, every integer/bool
array equal with the same dtype, and the derived float metrics ``==``.
Also here: the port's construction-time refusals and its device rule.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import sim as jsim
from repro_torch.core import sim as tsim
from repro_torch.faults import FaultPlan
from jax_cache import release_compiled  # noqa: F401


def _assert_results_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), k
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, (k, g, w)


POINTS = {
    "zipf0_colibri": dict(protocol="colibri", workload="zipf_histogram",
                          zipf_skew=0, n_cores=64, n_addrs=16, cycles=1500,
                          seed=3),
    "zipf0_lrsc_1bin": dict(protocol="lrsc", workload="zipf_histogram",
                            zipf_skew=0, n_cores=64, n_addrs=1, cycles=1500,
                            seed=4),
    "zipf0_amo": dict(protocol="amo", workload="zipf_histogram",
                      zipf_skew=0, n_cores=32, n_addrs=64, cycles=1000),
    "workers_lrsc": dict(protocol="lrsc", n_cores=64, n_addrs=1,
                         n_workers=8, net_bw=13, hol_block=16, cycles=1500,
                         backoff=128, backoff_exp=1, seed=5),
    "workers_colibri": dict(protocol="colibri", n_cores=64, n_addrs=2,
                            n_workers=16, net_bw=13, hol_block=4,
                            cycles=1500, seed=6),
    "lrscwait_q8": dict(protocol="lrscwait", n_cores=64, n_addrs=1,
                        q_slots=8, cycles=1500, seed=4),
    "lrscwait_q8_4bins": dict(protocol="lrscwait", n_cores=64, n_addrs=4,
                              q_slots=8, cycles=1500, seed=8, lat=3),
}


@pytest.mark.parametrize("name", sorted(POINTS))
def test_execute_matches_reference_key_for_key(name):
    cfg = POINTS[name]
    want = jsim.execute(jsim.SimParams(backend="xla_cpu", **cfg))
    got = tsim.execute(tsim.SimParams(**cfg), device="cpu")
    _assert_results_equal(got, want)


def test_bank_state_keys_and_dtypes_follow_the_protocol():
    got = tsim.execute(tsim.SimParams(protocol="lrsc", n_cores=8,
                                      n_addrs=2, cycles=50), device="cpu")
    assert got["resv_valid"].dtype == np.bool_
    assert got["resv_core"].dtype == np.int32
    assert got["parked"].dtype == np.bool_
    assert got["msgs"].shape == () and got["msgs"].dtype == np.int32


# ---------------------------------------------------------------------------
# construction-time rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(faults={"n_stall": 2, "stall_dur": 10}),
    dict(faults={"n_bank_stall": 1, "bank_stall_dur": 10}),
    dict(faults={"msg_drop_bp": 100}),
    dict(faults=FaultPlan(n_kill=1)),
    dict(faults={"watchdog_cyc": 64}),
])
def test_unported_features_are_refused(kw):
    """The five fault plans the port once refused now run, and equal the
    reference on every key."""
    from lock_points import assert_execute_matches_reference
    plan = tsim.SimParams(**kw).faults
    assert plan.enabled
    got = assert_execute_matches_reference(
        "colibri", dict(n_cores=16, n_addrs=2, cycles=300, seed=4,
                        faults=dataclasses.asdict(plan)))
    assert "dead_mask" in got and "halt_cyc" in got


def test_skew_is_ignored_where_no_zipf_stream_runs():
    # rmw_loop has no Zipf step: the default zipf_skew=100 is inert there
    assert tsim.SimParams(workload="rmw_loop").zipf_skew == 100


def test_unported_names_list_what_the_port_has():
    from repro.core import protocols as jprotocols
    from repro_torch.core import protocols as tprotocols
    ported = ("amo, amo_lock, colibri, colibri_hier, hw_event, lrsc, "
              "lrsc_lock, lrscwait, mwait_lock, nb_feb, ticket_lock")
    with pytest.raises(ValueError, match=ported):
        tsim.SimParams(protocol="no_such_protocol")
    # the port registers every protocol the reference does
    assert tprotocols.names() == jprotocols.names()
    assert ", ".join(tprotocols.names()) == ported
    # the port registers every workload the reference does
    from repro.core import workloads as jworkloads
    from repro_torch.core import workloads as tworkloads
    assert tworkloads.names() == jworkloads.names()
    wls = ("barrier_phases, ms_queue, rmw_loop, treiber_stack, "
           "zipf_histogram")
    assert ", ".join(tworkloads.names()) == wls
    with pytest.raises(ValueError, match=wls):
        tsim.SimParams(workload="no_such_workload")
    assert tsim.SimParams(workload="ms_queue", n_addrs=2).workload \
        == "ms_queue"
    # and every topology the reference does
    from repro.core import topologies as jtopologies
    from repro_torch.core import topologies as ttopologies
    assert ttopologies.names() == jtopologies.names()
    with pytest.raises(ValueError,
                       match="registered topologies: cluster2, cluster3, "
                             "flat"):
        tsim.SimParams(topology="no_such_topology")


def test_backend_accepts_auto_only():
    assert tsim.SimParams(backend="auto").backend == "auto"
    for b in ("xla_cpu", "pallas_interpret", "cuda"):
        with pytest.raises(ValueError, match="the port accepts: auto"):
            tsim.SimParams(backend=b)


def test_bounds_match_the_reference():
    for kw in (dict(n_cores=0), dict(cycles=0), dict(lat=-1),
               dict(seed=1.5), dict(record_trace=1)):
        with pytest.raises(ValueError):
            tsim.SimParams(**kw)
        with pytest.raises(ValueError):
            jsim.SimParams(**kw)


def test_execute_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tsim.SimParams(n_cores=8, cycles=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.execute(p)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.execute(p, device="cuda")
    assert tsim.execute(p, device="cpu")["ops"].shape == (8,)
