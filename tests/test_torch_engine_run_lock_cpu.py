"""``engine_run_kernel``'s own source on the CPU against the plain loop:
the lock baselines (``amo_lock`` and ``lrsc_lock`` on the lock branch,
``ticket_lock`` on the ticket branch, ``mwait_lock`` on the queue branch).

See ``tests/engine_mock.py`` for the build and the comparison: every key
of the result, ``ticket_lock``'s per-core ``tkt`` included, must equal
``_simulate_plain(p, "cpu")``.  Here: each protocol at the golden points,
traced with telemetry, on the skew-0 Zipf stream, ``lrsc_lock``'s
two-round-trip acquire at a long latency, and ``ticket_lock`` past 2 048
cores, where the held tickets live in device memory with the rest of the
per-core state.  Skips without g++.
"""
import pytest

from engine_mock import TRACED, check, mock_library  # noqa: F401
from test_protocols import GOLDEN_CONFIGS

PROTOS = ("amo_lock", "lrsc_lock", "ticket_lock", "mwait_lock")
CASES = (
    [pytest.param(dict(protocol=pr, **cfg), id=f"{pr}/{i}")
     for pr in PROTOS for i, cfg in enumerate(GOLDEN_CONFIGS)]
    + [pytest.param(dict(protocol=pr, n_cores=64, n_addrs=16, cycles=500,
                         seed=2, **TRACED), id=f"{pr}/64x16/traced")
       for pr in PROTOS]
    + [pytest.param(dict(protocol=pr, workload="zipf_histogram",
                         zipf_skew=0, n_cores=40, n_addrs=4, cycles=500,
                         lat=3, work=6, modify=2, net_bw=5, seed=-3),
                    id=f"{pr}/40x4/zipf")
       for pr in PROTOS]
    + [pytest.param(dict(protocol="lrsc_lock", n_cores=32, n_addrs=2,
                         lat=11, work=3, modify=1, cycles=800, seed=6,
                         backoff=16, **TRACED), id="lrsc_lock/2lat-acquire"),
       pytest.param(dict(protocol="ticket_lock", workload="zipf_histogram",
                         zipf_skew=0, n_cores=2100, n_addrs=8, cycles=120,
                         lat=2, work=1, modify=1, backoff=4, seed=11),
                    id="ticket_lock/cores-in-device-memory")])


@pytest.mark.parametrize("kw", CASES)
def test_kernel_source_on_the_cpu_equals_the_plain_loop(kw, mock_library,
                                                        tmp_path):
    assert check(mock_library, tmp_path, kw) == []
