"""The batched launch of ``engine_run_kernel`` (a grid of run blocks,
``run_cuda_batch``'s packing through ``pack_runs``) on the CPU.

See ``tests/engine_mock.py`` for the build.  Mixed batches whose blocks
differ in protocol, seed, live ``n_addrs`` below the bank bucket, queue
capacity, workers, cycles and trace switches, one of them on the scratch
layout with a scratch slice per block, and one with every protocol family
of the kernel in one launch, run with the blocks in index order and
reversed: each block's slice must equal ``_simulate_plain`` of its point
at its banks.  Skips without g++.
"""
import pytest

from engine_mock import check_batch, mock_library  # noqa: F401

#: batches of one launch: (points, banks of each block, None for the
#: sweep's bucket).  "mixed": four protocols, live n_addrs below the
#: bucket (3 of 4, 5 of 8, 6 of 8), queue capacities 32 and 8, workers
#: with head-of-line blocking, seeds past the int32 range, different
#: cycles, traced and untraced; "scratch": two blocks whose banks live
#: in the scratch (a slice each) beside one in shared memory;
#: "families": the five bank-update branches (amo, lrsc, the queue of
#: colibri and mwait_lock, the lock bit, the ticket dispenser) side by
#: side, so that blocks of different families share one layout of the
#: per-bank slots
BATCHES = {
    "mixed": ([
        dict(protocol="colibri", n_cores=32, n_addrs=3, cycles=120, seed=1,
             record_trace=True, telemetry_windows=8),
        dict(protocol="lrscwait", n_cores=32, n_addrs=5, q_slots=8,
             n_workers=6, net_bw=9, hol_block=4, work=2, modify=1,
             cycles=150, seed=-7),
        dict(protocol="lrsc", workload="zipf_histogram", zipf_skew=0,
             n_cores=32, n_addrs=6, backoff=16, backoff_exp=2, cycles=100,
             seed=2**40 + 3, record_trace=True),
        dict(protocol="amo", n_cores=32, n_addrs=1, lat=3, work=6,
             modify=2, cycles=130, seed=9)], None),
    "scratch": ([
        dict(protocol="lrsc", workload="zipf_histogram", zipf_skew=0,
             n_cores=32, n_addrs=6300, cycles=12, seed=3),
        dict(protocol="colibri", workload="zipf_histogram", zipf_skew=0,
             n_cores=32, n_addrs=6400, cycles=12, seed=4, record_trace=True,
             telemetry_windows=4),
        dict(protocol="amo", n_cores=32, n_addrs=3, cycles=12, seed=5)],
        [6300, 6400, 4]),
    "families": ([
        dict(protocol="ticket_lock", n_cores=48, n_addrs=3, cycles=400,
             backoff=8, seed=12, record_trace=True, telemetry_windows=5),
        dict(protocol="amo_lock", n_cores=48, n_addrs=2, cycles=300,
             backoff=8, seed=13),
        dict(protocol="mwait_lock", workload="zipf_histogram", zipf_skew=0,
             n_cores=48, n_addrs=5, cycles=350, seed=14, record_trace=True),
        dict(protocol="lrsc_lock", n_cores=48, n_addrs=1, lat=4,
             cycles=380, backoff=8, seed=15, telemetry_windows=3),
        dict(protocol="colibri", n_cores=48, n_addrs=3, cycles=200, seed=16),
        dict(protocol="lrsc", n_cores=48, n_addrs=6, cycles=250,
             backoff=16, seed=17),
        dict(protocol="amo", n_cores=48, n_addrs=7, cycles=150, seed=18)],
        None),
}


@pytest.mark.parametrize("order", [0, 1], ids=["index", "reversed"])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batched_launch_equals_the_plain_loop_per_block(name, order,
                                                        mock_library,
                                                        tmp_path):
    from repro_torch.core.sweep import _bucket_a
    kws, banks = BATCHES[name]
    banks = banks or [_bucket_a(kw["n_addrs"]) for kw in kws]
    assert any(b > kw["n_addrs"] for b, kw in zip(banks, kws))
    got = check_batch(mock_library, tmp_path, kws, banks, order)
    assert got == [[]] * len(kws)


def test_the_families_share_the_per_bank_slots(mock_library):
    """The lock and ticket state take the slots of lrsc's and the
    queue's, so where the per-bank state lives is what it was: Fig. 3's
    and Fig. 4's largest point (256 cores, 1 024 banks) in shared memory,
    chip_smoke's (300, 7 000) layout case in the scratch."""
    from engine_mock import _bind
    lib = _bind(str(mock_library))
    assert lib.engine_run_smem_bytes(256, 1024) > 0
    assert lib.engine_run_scratch_bytes(256, 1024) == 0
    assert lib.engine_run_smem_bytes(300, 7000) == 0
    assert lib.engine_run_scratch_bytes(300, 7000) > 0
