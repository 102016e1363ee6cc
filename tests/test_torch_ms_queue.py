"""The port's ``ms_queue`` workload against the reference, bit for bit.

Each of the eleven protocols runs the queue's scenario (head and tail
words, ``modify`` 8) at 16 cores, traced, with telemetry on every other
protocol: every key of the port's result on the CPU equals the
reference's, the program identities hold on the reference's result,
and the port's ``Result.check()`` replays the queue's laws (pops never
overtake pushes, at most one pop a cycle, per-core enqueue/dequeue
alternation) with no poll for the polling-free protocols
(``tests/program_points.py``).
"""
import pytest

from program_points import PROTOS, assert_matches_reference
from jax_cache import release_compiled  # noqa: F401


@pytest.mark.parametrize("i,proto", list(enumerate(PROTOS)))
def test_ms_queue_matches_reference_key_for_key(i, proto):
    r = assert_matches_reference(
        proto, "ms_queue", n_cores=16, n_addrs=2, modify=8, cycles=1000,
        seed=11 * i - 7, record_trace=True, telemetry_windows=16 * (i % 2))
    info = r.check()
    assert info["pushes"] + info["pops"] == info["atomics"]
    assert abs(info["pushes"] - info["pops"]) <= 16
