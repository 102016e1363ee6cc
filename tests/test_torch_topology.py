"""The hierarchical topologies of the port against the reference.

``cluster2`` and ``cluster3`` (``repro_torch.core.topologies.cluster``)
in the plain loop: a crossing request pays its levels' extra latency at
issue, wins one of each crossed level's link slots (the rotating-fair
arbiter over that level's requesters), and the ``hops`` counter bills
every accepted request's hop path twice; the telemetry splits accepted
requests into local and cross-cluster ones.  Every key of
``repro_torch.core.sim.execute`` on the CPU (``hops``, ``tele`` and the
energy that bills ``e_hop`` included) equals ``repro.core.sim.execute``'s
for the protocols below on both topologies, with link budgets small
enough to turn requests away; fewer banks than clusters, Fig. 5 workers
and a workload program too; a ``Study`` of topology points equals the
reference's (bank tables at the sweep's bucket); ``flat`` carries no
``hops`` and ignores ``clusters``; the tables equal the reference's and
the Perfetto export of a traced cluster2 run its ``noc`` track.
"""
import numpy as np
import pytest

import repro.sync as jsync
from lock_points import assert_execute_matches_reference
from repro.core import topologies as jtopologies
from repro.obs import perfetto as jperfetto
from repro_torch import sync as tsync
from repro_torch.core import sim as tsim
from repro_torch.core import topologies as ttopologies
from repro_torch.obs import perfetto as tperfetto
from jax_cache import release_compiled  # noqa: F401

PROTOS = ("colibri", "lrsc", "lrscwait", "colibri_hier", "hw_event",
          "nb_feb", "ticket_lock")
#: per topology: its cluster count and a network budget whose levels'
#: share (net_bw // bw_div) turns crossing requests away
TOPOS = {"cluster2": dict(clusters=4, net_bw=9),
         "cluster3": dict(clusters=8, net_bw=13)}


@pytest.mark.parametrize("topology", sorted(TOPOS))
@pytest.mark.parametrize("proto", PROTOS)
def test_execute_matches_reference_key_for_key(proto, topology):
    kw = dict(topology=topology, n_cores=32, n_addrs=4, cycles=400, seed=3,
              telemetry_windows=8, **TOPOS[topology])
    got = assert_execute_matches_reference(proto, kw)
    assert int(got["hops"]) > 0 and int(got["ops"].sum()) > 0
    xcl = got["tele"][:, 12]
    assert int(xcl.sum()) > 0 and int(got["tele"][:, 11].sum()) > 0


@pytest.mark.parametrize("name,kw", [
    ("fewer-banks-than-clusters", dict(
        protocol="lrscwait", topology="cluster3", clusters=8, n_cores=40,
        n_addrs=3, cycles=400, seed=1, telemetry_windows=4)),
    ("workers", dict(
        protocol="colibri", topology="cluster2", clusters=4, n_cores=48,
        n_addrs=2, n_workers=8, net_bw=13, hol_block=16, cycles=400,
        seed=2, telemetry_windows=4)),
    ("program", dict(
        protocol="colibri_hier", workload="ms_queue", topology="cluster2",
        n_cores=32, n_addrs=2, cycles=500, seed=4, net_bw=9)),
    ("zipf-skewed-traced", dict(
        protocol="lrsc", workload="zipf_histogram", zipf_skew=150,
        topology="cluster3", clusters=4, n_cores=32, n_addrs=64,
        cycles=400, seed=5, record_trace=True, telemetry_windows=8)),
])
def test_edge_points_match_reference(name, kw):
    got = assert_execute_matches_reference(kw.pop("protocol"), kw)
    assert int(got["hops"]) > 0


def test_hops_converts_with_the_state():
    """``hops`` is a 0-d int32 key that ``convert`` carries both ways."""
    from repro_torch import convert
    res = tsim.execute(tsim.SimParams(protocol="colibri", topology="cluster2",
                                      n_cores=16, n_addrs=4, cycles=200),
                       device="cpu")
    back = convert.to_numpy(convert.to_torch(res, "cpu"))
    assert back["hops"].dtype == np.int32 and back["hops"].shape == ()
    assert int(back["hops"]) == int(res["hops"]) > 0


def test_flat_has_no_hops_and_ignores_clusters():
    base = dict(protocol="colibri", workload="zipf_histogram", zipf_skew=0,
                n_cores=16, n_addrs=4, cycles=300, telemetry_windows=4)
    r1 = tsim.execute(tsim.SimParams(clusters=1, **base), device="cpu")
    r4 = tsim.execute(tsim.SimParams(clusters=4, **base), device="cpu")
    assert "hops" not in r1 and set(r1) == set(r4)
    for k in r1:
        np.testing.assert_array_equal(r1[k], r4[k], err_msg=k)
    assert int(r1["tele"][:, 12].sum()) == 0


def test_study_of_topology_points_matches_reference():
    """Banks allocated at the sweep's bucket (3 of 4, 5 of 8) with fewer
    banks than clusters, flat and hierarchical points in one Study."""
    specs = [dict(protocol=pr, topology=tp, clusters=c, n_cores=24,
                  n_addrs=na, cycles=300, seed=s, net_bw=9)
             for s, (pr, tp, c, na) in enumerate((
                 ("colibri", "flat", 4, 3), ("colibri", "cluster2", 4, 3),
                 ("lrsc", "cluster2", 8, 5), ("nb_feb", "cluster3", 8, 3),
                 ("hw_event", "cluster2", 4, 5)))]
    ref = jsync.Study.from_specs([jsync.Spec(**d) for d in specs]).run()
    got = tsync.Study.from_specs([tsync.Spec(**d) for d in specs]).run(
        device="cpu")
    for d, g, w in zip(specs, got, ref):
        assert g.ok and set(g.stats) == set(w.stats), d
        assert ("hops" in g.stats) == (d["topology"] != "flat")
        for k, v in w.stats.items():
            a, b = np.asarray(g.stats[k]), np.asarray(v)
            assert a.dtype == b.dtype and np.array_equal(a, b), (d, k)


@pytest.mark.parametrize("name", ["cluster2", "cluster3"])
def test_tables_match_reference(name):
    tt, jt = ttopologies.get(name), jtopologies.get(name)
    assert tt.uses_default_tree()
    assert [(lv.name, lv.extra_lat, lv.bw_div) for lv in tt.levels] == \
        [(lv.name, lv.extra_lat, lv.bw_div) for lv in jt.levels]
    for n, a, c in ((32, 4, 4), (48, 3, 8), (100, 7, 3), (16, 64, 16)):
        p = tsim.SimParams(topology=name, n_cores=n, n_addrs=a, clusters=c)
        mine, want = tt.tables(p, n, a), jt.tables(p, n, a)
        for k in ("hops", "extra", "core_cluster", "bank_cluster"):
            np.testing.assert_array_equal(getattr(mine, k),
                                          getattr(want, k))
        for x, y in zip(mine.cross, want.cross):
            np.testing.assert_array_equal(x, y)


def test_perfetto_noc_track_matches_reference():
    kw = dict(protocol="colibri", workload="zipf_histogram", zipf_skew=150,
              topology="cluster2", clusters=4, n_cores=16, n_addrs=4,
              cycles=300, record_trace=True, telemetry_windows=8)
    got = tsync.run(tsync.Spec(**kw), device="cpu")
    want = jsync.run(jsync.Spec(**kw))
    ev = tperfetto.to_trace_events(got)
    assert ev == jperfetto.to_trace_events(want)
    noc = [e for e in ev if e["ph"] == "C" and e["name"] == "link msgs"]
    assert sum(e["args"]["cross_cluster"] for e in noc) > 0


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_topology_is_the_bench_topology_grid():
    """The topology phase runs ``benchmarks/bench_topology.py``'s points at
    their full length, one launch per core count, and holds them to the
    committed ``reports/benchmarks.topology.json``; the Fig. 3 skewed
    lines are ``bench_histogram.py``'s."""
    import json
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from benchmarks import bench_histogram as bh
    from benchmarks import bench_topology as bt
    cs = _chip_smoke()
    assert (cs.TOPO_CORES, cs.TOPO_CYCLES, cs.TOPO_CLUSTERS,
            cs.TOPO_ADDRS, cs.TOPO_MATRIX, cs.TOPO_LADDER) == (
        bt.CORES, bt.CYCLES, bt.CLUSTERS, bt.N_ADDRS, bt.MATRIX, bt.LADDER)
    names, specs = cs.topology_specs()
    want = [jsync.Spec(protocol=pr, topology=tp, clusters=bt.CLUSTERS,
                       n_cores=n, n_addrs=bt.N_ADDRS, cycles=bt.CYCLES)
            for n in bt.CORES for pr, tp in bt.MATRIX]
    want += [jsync.Spec(protocol="colibri_hier", topology=tp,
                        clusters=bt.CLUSTERS, n_cores=bt.CORES[0],
                        n_addrs=bt.N_ADDRS, cycles=bt.CYCLES)
             for tp in bt.LADDER]
    assert [s.to_dict() for s in specs] == [
        tsync.Spec.from_json(w.to_json()).to_dict() for w in want]
    assert cs.TOPO_LAUNCHES == len({s.to_params().n_cores for s in specs})
    rep = json.loads((root / "reports" / "benchmarks.topology.json")
                     .read_text())["topology"]["rows"]
    assert names == [r["row"] for r in rep]
    assert cs.TOPO_REF == {
        r["row"]: (r["throughput"], r["jain_fairness"], r["polls"],
                   r["msgs"], r["ops"], r["hops_per_op"]) for r in rep}
    assert cs.FIG3_SKEW_CYCLES == bh.CYCLES
    skewed = [s for s in cs.fig3_skew_specs()]
    assert [(s.protocol.name, s.topology.n_addrs) for s in skewed] == [
        (pr, b) for pr in ("colibri", "lrsc") for b in bh.BINS]
    assert {s.workload.zipf_skew for s in skewed} == {cs.FIG3_SKEW} == {150}
