"""Points at which the lock baselines are held against the reference.

Shared by ``tests/test_torch_spin_locks.py`` (``amo_lock``,
``lrsc_lock``) and ``tests/test_torch_fifo_locks.py`` (``ticket_lock``,
``mwait_lock``): the three golden configurations, both one-step
programs (``rmw_loop`` and ``zipf_histogram`` at skew 0), Fig. 5 workers
with head-of-line blocking, and a traced run with telemetry.  Every key
of ``repro_torch.core.sim.execute`` on the CPU must equal
``repro.core.sim.execute``'s, ``ticket_lock``'s per-core ``tkt``
included.
"""
import numpy as np
import pytest

from repro.core import sim as jsim
from repro_torch.core import sim as tsim
from test_protocols import GOLDEN_CONFIGS

#: (name, SimParams fields) of each point, the protocol left out
POINTS = (
    [(f"golden/{i}", cfg) for i, cfg in enumerate(GOLDEN_CONFIGS)]
    + [("rmw_loop", dict(workload="rmw_loop", n_cores=48, n_addrs=3,
                         cycles=1200, lat=4, backoff=64, seed=-11)),
       ("zipf0", dict(workload="zipf_histogram", zipf_skew=0, n_cores=64,
                      n_addrs=16, cycles=1200, seed=-9876)),
       ("workers", dict(n_cores=64, n_addrs=1, n_workers=8, net_bw=13,
                        hol_block=16, cycles=1500, backoff=128,
                        backoff_exp=1, seed=5)),
       ("traced", dict(workload="zipf_histogram", zipf_skew=0, n_cores=32,
                       n_addrs=4, cycles=600, seed=7, record_trace=True,
                       telemetry_windows=16))])


def cases(protos):
    return [pytest.param(pr, kw, id=f"{pr}/{name}")
            for pr in protos for name, kw in POINTS]


def assert_execute_matches_reference(proto: str, kw: dict) -> dict:
    """The port's result dict on the CPU against the reference's, key
    for key; returns the port's."""
    want = jsim.execute(jsim.SimParams(protocol=proto, backend="xla_cpu",
                                       **kw))
    got = tsim.execute(tsim.SimParams(protocol=proto, **kw), device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), k
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, (k, g, w)
    return got
