"""``engine_run_kernel``'s own source on the CPU against the plain loop:
the retry family (``amo``, ``lrsc``), and the per-core layouts.

The build, the launch through the wrapper's packing and the comparison
are ``tests/engine_mock.py``'s: every key of the result must equal
``_simulate_plain(p, "cpu")``.  Here: each protocol at the golden
points, traced and untraced, with telemetry, workers, negative and large
seeds, and two cores a thread (K = 2).  The queue and lock families and
the batched launch have files of their own
(``test_torch_engine_run_{queue,lock,batch}_cpu.py``), so that
``--dist loadfile`` runs them on different workers.  Skips without g++.
"""
import pytest

from engine_mock import TRACED, check, mock_library  # noqa: F401
from test_protocols import GOLDEN_CONFIGS, GOLDEN_EXTRA

PROTOS = ("amo", "lrsc")
CASES = (
    [pytest.param(dict(protocol=pr, **cfg), id=f"{pr}/{i}")
     for pr in PROTOS for i, cfg in enumerate(GOLDEN_CONFIGS)]
    + [pytest.param(dict(GOLDEN_EXTRA["lrsc_workers"][0]), id="lrsc_workers"),
       pytest.param(dict(protocol="lrsc", workload="zipf_histogram",
                         zipf_skew=0, n_cores=40, n_addrs=3, cycles=1500,
                         seed=2**40 + 9, n_workers=4, net_bw=9,
                         record_trace=True, telemetry_windows=7),
                    id="lrsc/zipf/workers/traced")]
    + [pytest.param(dict(protocol=pr, n_cores=64, n_addrs=16, cycles=500,
                         seed=2, **TRACED), id=f"{pr}/64x16/traced")
       for pr in PROTOS]
    + [pytest.param(dict(protocol=pr, workload="zipf_histogram",
                         zipf_skew=0, n_cores=40, n_addrs=4, cycles=500,
                         lat=3, work=6, modify=2, net_bw=5, seed=-3),
                    id=f"{pr}/40x4/zipf")
       for pr in PROTOS]
    + [pytest.param(dict(protocol="lrsc", workload="zipf_histogram",
                         zipf_skew=0, n_cores=1500, n_addrs=64, cycles=80,
                         seed=7, **TRACED), id="lrsc/two-cores-a-thread")])


@pytest.mark.parametrize("kw", CASES)
def test_kernel_source_on_the_cpu_equals_the_plain_loop(kw, mock_library,
                                                        tmp_path):
    assert check(mock_library, tmp_path, kw) == []
