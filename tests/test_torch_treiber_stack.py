"""The port's ``treiber_stack`` workload against the reference, bit for
bit.

Each of the eleven protocols runs the stack's scenario (one
top-of-stack word) at 16 cores, traced, with telemetry on every other
protocol: every key of the port's result on the CPU equals the
reference's, the program identities hold on the reference's result,
and the port's ``Result.check()`` replays the stack's per-core LIFO law
with no poll for the polling-free protocols
(``tests/program_points.py``).
"""
import pytest

from program_points import PROTOS, assert_matches_reference
from jax_cache import release_compiled  # noqa: F401


@pytest.mark.parametrize("i,proto", list(enumerate(PROTOS)))
def test_treiber_stack_matches_reference_key_for_key(i, proto):
    r = assert_matches_reference(
        proto, "treiber_stack", n_cores=16, n_addrs=1, cycles=1000,
        lat=3 + i % 3, seed=5 * i + 1, record_trace=True,
        telemetry_windows=16 * ((i + 1) % 2))
    info = r.check()
    assert info["pops"] <= info["pushes"]
