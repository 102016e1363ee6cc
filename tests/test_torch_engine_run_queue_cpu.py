"""``engine_run_kernel``'s own source on the CPU against the plain loop:
the queue family (``lrscwait``, ``colibri``), and per-core and per-bank
state in device memory.

See ``tests/engine_mock.py`` for the build and the comparison: every key
of the result must equal ``_simulate_plain(p, "cpu")``.  Here: each
protocol at the golden points, traced and untraced, with telemetry, the
finite queue that rejects, workers with head-of-line blocking, the
skew-0 Zipf stream, and more than 2 048 cores with more banks than
shared memory holds.  Skips without g++.
"""
import pytest

from engine_mock import TRACED, check, mock_library  # noqa: F401
from test_protocols import GOLDEN_CONFIGS, GOLDEN_EXTRA

PROTOS = ("lrscwait", "colibri")
CASES = (
    [pytest.param(dict(protocol=pr, **cfg), id=f"{pr}/{i}")
     for pr in PROTOS for i, cfg in enumerate(GOLDEN_CONFIGS)]
    + [pytest.param(dict(GOLDEN_EXTRA["colibri_workers"][0]),
                    id="colibri_workers"),
       pytest.param(dict(protocol="lrscwait", **GOLDEN_EXTRA["lrscwait_q8"][0],
                         telemetry_windows=64), id="lrscwait_q8/tele"),
       pytest.param(dict(protocol="colibri", workload="zipf_histogram",
                         zipf_skew=0, n_cores=64, n_addrs=16, cycles=1500,
                         seed=-12345, record_trace=True,
                         telemetry_windows=64), id="colibri/zipf/traced")]
    + [pytest.param(dict(protocol=pr, n_cores=64, n_addrs=16, cycles=500,
                         seed=2, **TRACED), id=f"{pr}/64x16/traced")
       for pr in PROTOS]
    + [pytest.param(dict(protocol=pr, workload="zipf_histogram",
                         zipf_skew=0, n_cores=40, n_addrs=4, cycles=500,
                         lat=3, work=6, modify=2, net_bw=5, seed=-3),
                    id=f"{pr}/40x4/zipf")
       for pr in PROTOS]
    + [pytest.param(dict(protocol="colibri", n_cores=64, n_addrs=1,
                         n_workers=8, net_bw=13, hol_block=16, cycles=600,
                         backoff=128, backoff_exp=1, seed=5, **TRACED),
                    id="colibri/workers/traced"),
       pytest.param(dict(protocol="lrscwait", n_cores=64, n_addrs=1,
                         q_slots=8, cycles=600, seed=4), id="lrscwait/q8"),
       pytest.param(dict(protocol="colibri", workload="zipf_histogram",
                         zipf_skew=0, n_cores=2100, n_addrs=7000, cycles=50,
                         seed=9, **TRACED),
                    id="colibri/cores-and-banks-in-device-memory")])


@pytest.mark.parametrize("kw", CASES)
def test_kernel_source_on_the_cpu_equals_the_plain_loop(kw, mock_library,
                                                        tmp_path):
    assert check(mock_library, tmp_path, kw) == []
