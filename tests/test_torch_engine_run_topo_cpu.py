"""``engine_run_kernel``'s own source on the CPU against the plain loop:
the topology instance (``cluster2``, ``cluster3``) and the skewed Zipf
stream's threshold lookup.

See ``tests/engine_mock.py`` for the build and the comparison: every key
of the result (``hops`` and the telemetry's local/cross-cluster split
included) must equal ``_simulate_plain``'s.  Here: protocols of every
kernel family on both topologies with link budgets that turn crossing
requests away, fewer banks than clusters with workers, a workload
program with a barrier, the two register layouts past 1 024 cores and
the cores in device memory; the skewed stream in the single run's and
the sweep's form, the log-uniform limit and the skew-0 fused
multiply-add at a bin count where two roundings differ; and one launch
of flat and hierarchical points and skewed streams (two blocks sharing
a threshold table), blocks in index and reversed order.  A launch
without a hierarchical topology keeps its instance.  Skips without g++.
"""
import pytest

from engine_mock import TRACED, check, check_batch, mock_library  # noqa: F401

C2 = dict(topology="cluster2", clusters=4)
C3 = dict(topology="cluster3", clusters=8)
CASES = (
    [pytest.param(dict(protocol=pr, n_cores=32, n_addrs=4, cycles=300,
                       seed=i, net_bw=9, **C2, **TRACED),
                  id=f"{pr}/cluster2")
     for i, pr in enumerate(("colibri", "lrsc", "amo_lock"))]
    + [pytest.param(dict(protocol=pr, n_cores=64, n_addrs=16, cycles=300,
                         seed=i, net_bw=13, **C3, **TRACED),
                    id=f"{pr}/cluster3")
       for i, pr in enumerate(("colibri_hier", "nb_feb", "ticket_lock"))]
    + [pytest.param(dict(protocol="lrscwait", n_cores=40, n_addrs=3,
                         n_workers=6, net_bw=13, hol_block=4, cycles=300,
                         seed=4, **C3, **TRACED),
                    id="fewer-banks-than-clusters/workers"),
       pytest.param(dict(protocol="colibri", workload="barrier_phases",
                         n_cores=32, n_addrs=1, cycles=400, seed=6,
                         net_bw=9, **C2, **TRACED),
                    id="barrier_phases/cluster2"),
       pytest.param(dict(protocol="lrsc", n_cores=1100, n_addrs=8,
                         cycles=60, seed=7, net_bw=40, **C3,
                         telemetry_windows=3),
                    id="two-cores-a-thread/cluster3"),
       pytest.param(dict(protocol="colibri", n_cores=2100, n_addrs=16,
                         cycles=40, seed=8, net_bw=64, **C2,
                         telemetry_windows=2),
                    id="cores-in-device-memory/cluster2"),
       pytest.param(dict(protocol="lrsc", workload="zipf_histogram",
                         zipf_skew=150, n_cores=32, n_addrs=1000,
                         cycles=300, seed=304, **TRACED),
                    id="zipf-150/constant"),
       pytest.param(dict(protocol="colibri", workload="zipf_histogram",
                         zipf_skew=100, n_cores=32, n_addrs=64, cycles=300,
                         seed=2),
                    id="zipf-100"),
       pytest.param(dict(protocol="colibri", workload="zipf_histogram",
                         zipf_skew=0, n_cores=48, n_addrs=43, cycles=300,
                         seed=3),
                    id="zipf-0/43-bins")])

#: one launch of the sweep's form: flat and hierarchical points, skewed
#: streams (two blocks with one table), live n_addrs below the bucket
MIXED = [
    dict(protocol="lrsc", workload="zipf_histogram", zipf_skew=150,
         n_cores=32, n_addrs=1000, cycles=300, seed=304),
    dict(protocol="colibri", workload="zipf_histogram", zipf_skew=200,
         n_cores=32, n_addrs=64, cycles=250, seed=6, net_bw=9, **C2,
         telemetry_windows=5),
    dict(protocol="colibri", workload="zipf_histogram", zipf_skew=150,
         n_cores=32, n_addrs=1000, cycles=280, seed=7),
    dict(protocol="colibri", workload="zipf_histogram", zipf_skew=99,
         n_cores=32, n_addrs=16, cycles=300, seed=77, **C3),
    dict(protocol="amo", n_cores=32, n_addrs=5, cycles=200, seed=8),
    dict(protocol="hw_event", n_cores=32, n_addrs=3, cycles=220, seed=9,
         **C2, record_trace=True)]


@pytest.mark.parametrize("kw", CASES)
def test_kernel_source_on_the_cpu_equals_the_plain_loop(kw, mock_library,
                                                        tmp_path):
    assert check(mock_library, tmp_path, kw) == []


@pytest.mark.parametrize("order", [0, 1], ids=["index", "reversed"])
def test_mixed_launch_in_the_sweeps_form(order, mock_library, tmp_path):
    from repro_torch.core.sweep import _bucket_a
    banks = [_bucket_a(kw["n_addrs"]) for kw in MIXED]
    assert check_batch(mock_library, tmp_path, MIXED, banks, order,
                       traced=True) == [[]] * len(MIXED)


def test_launch_variants_and_refusals():
    """A hierarchical point takes the topology instance, a flat launch
    keeps its own; a skewed stream travels as one table a launch; a
    topology off the default tree, or deeper than the kernel's levels,
    is refused."""
    from repro_torch.core import protocols, sim, topologies, workloads
    from repro_torch.core.topologies.base import LinkLevel, Topology
    from repro_torch.kernels.engine_step import kernel as K

    def scalars(traced=False, **kw):
        p = sim.SimParams(**kw)
        return K.run_scalars(p, protocols.get(p.protocol),
                             workloads.get(p.workload).program(p),
                             traced=traced)

    flat = scalars(protocol="colibri", n_cores=32)
    c2 = scalars(protocol="colibri", n_cores=32, n_addrs=3, net_bw=9, **C2)
    c3 = scalars(protocol="lrsc", n_cores=40, net_bw=13, **C3)
    prog = scalars(protocol="colibri", workload="ms_queue", n_addrs=2,
                   n_cores=32)
    assert K.launch_variant([flat]) == K.INSTANCE_NARROW
    assert K.launch_variant([flat, prog]) == K.INSTANCE_PROG
    assert K.launch_variant([flat, c2]) == K.INSTANCE_TOPO
    assert K.launch_variant([prog, c2]) == K.INSTANCE_TOPO
    assert (c2["topo_levels"], c2["topo_core_size"],
            c2["topo_core_clusters"], c2["topo_bank_clusters"]) == \
        (1, 8, 4, 3)
    assert c2["level_extra"] == (8, 0) and c2["level_bw"] == (2, 0)
    assert c3["level_extra"] == (6, 12) and c3["level_bw"] == (6, 1)
    assert flat["topo_levels"] == 0 and flat["zipf_thr"] is None
    z = dict(protocol="lrsc", workload="zipf_histogram", zipf_skew=150,
             n_cores=32, n_addrs=1000)
    one, two = scalars(**z), scalars(**z)
    assert one["zipf_thr"] is two["zipf_thr"]
    assert one["zipf_n_thr"] == 999
    assert scalars(traced=True, **z)["zipf_thr"] is not one["zipf_thr"]
    # both blocks point at one copy of the table in the launch's buffer
    import torch
    p = sim.SimParams(**z)
    runs = [(p, protocols.get("lrsc"), sc) for sc in (one, two, flat)]
    packed = K.pack_runs(runs, "cpu")
    flat_buf = packed["flat"]
    at = packed["ptrs"] - flat_buf.data_ptr()
    ptrs = flat_buf[at:at + 8 * len(K.RUN_PTRS) * 3].view(torch.int64) \
        .reshape(3, -1)
    col = K.RUN_PTRS.index("zipf_thr")
    assert ptrs[0, col] == ptrs[1, col] != 0 and ptrs[2, col] == 0
    at = int(ptrs[0, col]) - flat_buf.data_ptr()
    table = flat_buf[at:at + 4 * 999].view(torch.int32)
    assert table.tolist() == one["zipf_thr"].tolist()

    class Moved(Topology):
        name = "moved_banks"
        levels = (LinkLevel("cluster", extra_lat=8, bw_div=4),)

        def bank_clusters(self, p, a):
            return super().bank_clusters(p, a)[::-1].copy()

    class Deep(Topology):
        name = "deep_levels"
        levels = tuple(LinkLevel(f"l{i}", extra_lat=1, bw_div=1)
                       for i in range(K.MAX_LEVELS + 1))

    for topo in (Moved, Deep):
        topologies.register(topo)
        try:
            with pytest.raises(NotImplementedError, match=topo.name):
                scalars(protocol="colibri", n_cores=32, topology=topo.name)
        finally:
            del topologies.registry._REGISTRY[topo.name]
