"""``engine_run_kernel``'s own source on the CPU against the plain loop:
the two-level queues (``colibri_hier``, ``hw_event``) and ``nb_feb``'s
full/empty bit.

See ``tests/engine_mock.py`` for the build and the comparison: every key
of the result (the local queues, the global FIFOs of groups, ``g_inq``,
``feb``, ...) must equal ``_simulate_plain(p, "cpu")``.  Here: each
protocol at the golden points, traced with telemetry, on the skew-0 Zipf
stream; ``colibri_hier`` at 3 groups (the last group larger); one run
past 2 048 cores, where the per-core state lives in device memory; and
one launch whose blocks mix ``colibri_hier`` at two group counts with
``colibri`` and ``nb_feb``, so the groups' geometry is a per-block
value.  These families run only on the kernel's wide instances, so a
launch that holds one runs every block there: the earlier families'
batch of ``tests/test_torch_engine_run_batch_cpu.py`` runs on the wide
instance too.  Beside them: the per-bank layout in shared memory is
what it was for every family (the two-level queues keep the words that
do not fit the shared slots in device memory).  Skips without g++.
"""
import importlib.util
from pathlib import Path

import pytest

from engine_mock import (TRACED, _bind, check, check_batch,  # noqa: F401
                         mock_library)
from test_protocols import GOLDEN_CONFIGS

PROTOS = ("colibri_hier", "hw_event", "nb_feb")
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
    + [pytest.param(dict(protocol="colibri_hier", n_groups=3, n_cores=64,
                         n_addrs=2, cycles=1500, seed=5, **TRACED),
                    id="colibri_hier/3-groups"),
       pytest.param(dict(protocol="colibri_hier", workload="zipf_histogram",
                         zipf_skew=0, n_cores=2100, n_addrs=8, n_groups=16,
                         cycles=120, lat=2, work=1, modify=1, seed=11),
                    id="colibri_hier/cores-in-device-memory")])

#: one launch: colibri_hier at two group counts beside colibri and
#: nb_feb, live n_addrs below the bank bucket
MIXED = [
    dict(protocol="colibri_hier", n_cores=48, n_addrs=3, n_groups=4,
         cycles=400, seed=21, record_trace=True, telemetry_windows=5),
    dict(protocol="colibri", n_cores=48, n_addrs=3, cycles=300, seed=22),
    dict(protocol="colibri_hier", workload="zipf_histogram", zipf_skew=0,
         n_cores=48, n_addrs=5, n_groups=7, cycles=350, seed=23),
    dict(protocol="nb_feb", n_cores=48, n_addrs=2, cycles=380, seed=24,
         record_trace=True),
    dict(protocol="hw_event", n_cores=48, n_addrs=1, n_groups=3,
         cycles=320, seed=25, telemetry_windows=3)]


@pytest.mark.parametrize("kw", CASES)
def test_kernel_source_on_the_cpu_equals_the_plain_loop(kw, mock_library,
                                                        tmp_path):
    assert check(mock_library, tmp_path, kw) == []


@pytest.mark.parametrize("order", [0, 1], ids=["index", "reversed"])
def test_mixed_group_counts_in_one_launch(order, mock_library, tmp_path):
    from repro_torch.core.sweep import _bucket_a
    banks = [_bucket_a(kw["n_addrs"]) for kw in MIXED]
    assert check_batch(mock_library, tmp_path, MIXED, banks, order) \
        == [[]] * len(MIXED)


def test_earlier_families_on_the_wide_instance(mock_library, tmp_path):
    from repro_torch.core.sweep import _bucket_a
    from test_torch_engine_run_batch_cpu import BATCHES
    kws, _ = BATCHES["families"]
    banks = [_bucket_a(kw["n_addrs"]) for kw in kws]
    assert check_batch(mock_library, tmp_path, kws, banks, variant=1) \
        == [[]] * len(kws)


def _kernel_shapes():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KERNEL_SHAPES


#: dynamic shared memory a block may use (the source's kMaxDynSmem)
_MAX_DYN_SMEM = 227 * 1024 - 1024


def _shared_layout_bytes(n: int, a: int) -> int:
    """The per-bank layout every family shares: the packed keys (2 x a
    u64), five int32 words a bank, the request words and a hierarchical
    topology's crossing request words (one set a level, MAX_LEVELS), a
    flag byte a bank and a wake flag a core, 16-byte aligned."""
    from repro_torch.kernels.engine_step.kernel import MAX_LEVELS
    words = 4 * ((n + 31) // 32) * (1 + MAX_LEVELS)
    return (16 * a + 20 * a + words + a + n + 15) & ~15


@pytest.mark.parametrize("n,a", _kernel_shapes())
def test_shared_memory_is_the_same_for_every_family(n, a, mock_library):
    """A launch's dynamic shared memory and scratch, as the wrapper
    computes them for a run of each of the eleven protocols, are the
    layout the families share, at every shape chip_smoke launches."""
    from repro_torch.core import protocols, sim, workloads
    from repro_torch.kernels.engine_step import kernel as K
    lib = _bind(str(mock_library))
    total = _shared_layout_bytes(n, a)
    smem = total if total <= _MAX_DYN_SMEM else 0
    for name in protocols.names():
        p = sim.SimParams(protocol=name, n_cores=n, n_addrs=a)
        pr = protocols.get(name)
        sc = K.run_scalars(p, pr, workloads.get(p.workload).program(p))
        assert K.launch_smem(lib, [sc]) == smem, name
        assert lib.engine_run_scratch_bytes(n, sc["a"]) == total - smem
