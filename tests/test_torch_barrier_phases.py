"""The port's ``barrier_phases`` workload against the reference, bit
for bit.

Each of the eleven protocols runs the barrier's scenario (one arrival
counter) at 16 cores, traced, with telemetry on every other protocol;
then with Fig. 5 workers beside the barrier (3 of the 16 cores stream
loads and never arrive).  Every key of the port's result on the CPU
equals the reference's (the barrier release, its wake messages in
``msgs`` and the next cycle's network budget, ``bar_cyc`` and the
telemetry's barrier column included), the program identities hold on
the reference's result, and the port's ``Result.check()`` holds the
bulk-synchronous laws (phases span at most 1, arrivals equal atomics)
with no poll for the polling-free protocols
(``tests/program_points.py``).
"""
import pytest

from program_points import PROTOS, assert_matches_reference
from jax_cache import release_compiled  # noqa: F401


@pytest.mark.parametrize("i,proto", list(enumerate(PROTOS)))
def test_barrier_phases_matches_reference_key_for_key(i, proto):
    r = assert_matches_reference(
        proto, "barrier_phases", n_cores=16, n_addrs=1, cycles=1000,
        seed=3 * i - 2, record_trace=True, telemetry_windows=16 * (i % 2))
    assert int(r.stats["bar_cyc"]) > 0


@pytest.mark.parametrize("proto", ["colibri", "lrsc", "mwait_lock",
                                   "colibri_hier"])
def test_barrier_phases_with_workers_matches_reference(proto):
    r = assert_matches_reference(
        proto, "barrier_phases", n_cores=16, n_addrs=1, n_workers=3,
        net_bw=13, hol_block=4, cycles=1000, seed=9, record_trace=True,
        telemetry_windows=8)
    assert int(r.stats["w_served"].sum()) > 0
    assert int(r.stats["bar_cnt"][:3].sum()) == 0
