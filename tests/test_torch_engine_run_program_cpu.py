"""``engine_run_kernel``'s own source on the CPU against the plain loop:
the two-step programs, ``ms_queue`` and ``treiber_stack``, on the
program instance of the kernel.

See ``tests/engine_mock.py`` for the build and the comparison: every key
of the result (``pc``, ``ops``, ``bar_cnt`` and the retired step ids of
``trace_step`` included) must equal ``_simulate_plain(p, "cpu")``.  One
protocol of each kernel family runs each workload's scenario at 16
cores, traced with telemetry on every other family.  Skips without g++.
"""
import pytest

from engine_mock import TRACED, check, mock_library  # noqa: F401

#: one protocol of each of the kernel's families
FAMILIES = ("lrsc", "colibri", "amo_lock", "ticket_lock", "colibri_hier",
            "nb_feb")
SCENARIOS = {"ms_queue": dict(n_addrs=2, modify=8),
             "treiber_stack": dict(n_addrs=1)}
CASES = [pytest.param(dict(protocol=pr, workload=wl, n_cores=16,
                           cycles=300, seed=7 * i + 1,
                           **(TRACED if i % 2 else {}), **sc),
                      id=f"{wl}/{pr}")
         for wl, sc in SCENARIOS.items() for i, pr in enumerate(FAMILIES)]


@pytest.mark.parametrize("kw", CASES)
def test_kernel_source_on_the_cpu_equals_the_plain_loop(kw, mock_library,
                                                        tmp_path):
    assert check(mock_library, tmp_path, kw) == []
