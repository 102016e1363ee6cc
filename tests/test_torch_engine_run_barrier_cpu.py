"""``engine_run_kernel``'s own source on the CPU against the plain loop:
barriers on the program instance of the kernel.

See ``tests/engine_mock.py`` for the build and the comparison: every key
of the result must equal ``_simulate_plain(p, "cpu")``.  Here:
``barrier_phases`` on one protocol of each kernel family (traced with
telemetry on every other), with Fig. 5 workers beside the barrier, with
the per-core state in device memory (more than 2 048 cores), the tests'
own program (``tests/own_program.py``: per-step local work and modify
durations, a barrier mid-program, every address mode), and one batched
launch in which one-step barrier-free runs share the program instance
with program runs, blocks in index and reversed order.  Skips without
g++.
"""
import pytest

from engine_mock import (TRACED, check, check_batch,  # noqa: F401
                         mock_library)
from own_program import OWN, OWN_PROGRAMS
from test_torch_engine_run_program_cpu import FAMILIES

CASES = (
    [pytest.param(dict(protocol=pr, workload="barrier_phases", n_cores=16,
                       n_addrs=1, cycles=300, seed=3 * i - 1,
                       **(TRACED if i % 2 == 0 else {})),
                  id=f"barrier_phases/{pr}")
     for i, pr in enumerate(FAMILIES)]
    + [pytest.param(dict(protocol=pr, workload="barrier_phases", n_cores=16,
                         n_addrs=1, n_workers=3, net_bw=13, hol_block=4,
                         cycles=300, seed=4, **TRACED),
                    id=f"barrier_phases/{pr}/workers")
       for pr in ("colibri", "lrsc")]
    + [pytest.param(dict(protocol="colibri", workload="barrier_phases",
                         n_cores=2100, n_addrs=1, work=2, lat=2,
                         cycles=40, seed=6, **TRACED),
                    id="barrier_phases/cores-in-device-memory")])
OWN_CASES = [pytest.param(dict(protocol=pr, workload=OWN, n_cores=16,
                               n_addrs=3, zipf_skew=0, cycles=400,
                               backoff=24, seed=5 + i, **TRACED),
                          id=f"{OWN}/{pr}")
             for i, pr in enumerate(("colibri", "lrsc", "ticket_lock",
                                     "colibri_hier"))]
#: one launch: one-step runs beside program runs (32 cores, banks at
#: their power-of-two bucket)
MIXED = [dict(protocol="amo", n_addrs=3, seed=1),
         dict(protocol="colibri", workload="ms_queue", n_addrs=2,
              modify=8, seed=2),
         dict(protocol="lrsc", workload="zipf_histogram", zipf_skew=0,
              n_addrs=5, seed=3, **TRACED),
         dict(protocol="nb_feb", workload="barrier_phases", n_addrs=1,
              seed=4),
         dict(protocol="ticket_lock", workload=OWN, n_addrs=3, zipf_skew=0,
              seed=5, **TRACED),
         dict(protocol="colibri_hier", workload="treiber_stack", n_addrs=1,
              n_workers=4, seed=6)]


@pytest.mark.parametrize("kw", CASES)
def test_kernel_source_on_the_cpu_equals_the_plain_loop(kw, mock_library,
                                                        tmp_path):
    assert check(mock_library, tmp_path, kw) == []


@pytest.mark.parametrize("kw", OWN_CASES)
def test_own_program_on_the_cpu_equals_the_plain_loop(kw, mock_library,
                                                      tmp_path):
    assert check(mock_library, tmp_path, kw, programs=OWN_PROGRAMS) == []


@pytest.mark.parametrize("order", [0, 1])
def test_one_step_runs_on_the_program_instance(order, mock_library,
                                               tmp_path):
    from repro_torch.core.sweep import _bucket_a
    kws = [dict(kw, n_cores=32, cycles=250) for kw in MIXED]
    banks = [_bucket_a(kw["n_addrs"]) for kw in kws]
    assert check_batch(mock_library, tmp_path, kws, banks, order,
                       programs=OWN_PROGRAMS) == [[]] * len(kws)
