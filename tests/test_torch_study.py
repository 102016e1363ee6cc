"""The port's ``Study`` and ``RunReport`` on the CPU, twins of the Study
tests of ``tests/test_sync_api.py``.

``repro_torch.sync.Study(...).run(device="cpu")`` and ``.stream()``
equal the reference's ``repro.sync.Study`` on the same spec dicts, key
for key; ordering, immutability and axis errors match; a spec the card's
kernel does not take is refused with ``NotImplementedError`` from
``Study.run(device="cuda")`` before any launch (a stubbed launch here);
``RunReport``/``collect`` record one chunk per launch with the
reference's keys.
"""
import numpy as np
import pytest
import torch

import repro.sync as jsync
from repro.obs import runreport as jrunreport
from repro_torch import obs as tobs
from repro_torch import sync as tsync
from repro_torch.core import sweep as tsweep
from jax_cache import release_compiled  # noqa: F401

BASE = dict(n_cores=16, cycles=200)


def _same(got, want):
    assert set(got.stats) == set(want.stats)
    for k, w in want.stats.items():
        g, w = np.asarray(got.stats[k]), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert np.array_equal(g, w), k


def _study(pkg):
    return pkg.Study(pkg.Spec(**BASE)) \
        .grid(protocol=("colibri", "lrsc"), n_addrs=(1, 3)) \
        .zip(seed=(0, 1, 2))


def test_study_run_and_stream_equal_the_reference():
    """The same grid through both packages: run() in point order, every
    key equal (bucket padding included); stream() the same points,
    identified by spec, over several chunks."""
    ref = _study(jsync).run()
    port = _study(tsync)
    assert len(port) == len(ref) == 12
    assert [s.to_dict() for s in port.specs()] == \
        [r.spec.to_dict() for r in ref]
    got = port.run(device="cpu")
    for g, w in zip(got, ref):
        assert g.spec.to_dict() == w.spec.to_dict()
        assert g.ok
        _same(g, w)
    streamed = {}
    for r in port.stream(max_batch=5, device="cpu"):
        assert r.spec not in streamed
        streamed[r.spec] = r
    assert set(streamed) == set(port.specs())
    for g in got:
        _same(streamed[g.spec], g)


def test_from_specs_takes_the_reference_spec_dicts():
    specs = [jsync.Spec(protocol="lrscwait", n_cores=16, n_addrs=a,
                        q_slots=q, cycles=200, seed=s)
             for a, q, s in ((1, 8, 3), (5, 16, 4))]
    ref = jsync.Study.from_specs(specs).run()
    got = tsync.Study.from_specs([s.to_dict() for s in specs]).run(
        device="cpu")
    for g, w in zip(got, ref):
        _same(g, w)
        assert g.to_row() == w.to_row()
        assert g.metrics() == w.metrics()


def test_study_grid_zip_ordering_and_immutability():
    s0 = tsync.Study(protocol="amo", n_cores=8, cycles=100)
    s1 = s0.grid(n_addrs=(1, 2), lat=(3, 5))
    s2 = s1.zip(seed=(0, 1), work=(10, 12))
    assert len(s0) == 1 and len(s1) == 4 and len(s2) == 8
    pts = [(x.topology.n_addrs, x.costs.lat, x.costs.seed, x.costs.work)
           for x in s2.specs()]
    assert pts == [(1, 3, 0, 10), (1, 3, 1, 12), (1, 5, 0, 10),
                   (1, 5, 1, 12), (2, 3, 0, 10), (2, 3, 1, 12),
                   (2, 5, 0, 10), (2, 5, 1, 12)]
    ref = jsync.Study(protocol="amo", n_cores=8, cycles=100) \
        .grid(n_addrs=(1, 2), lat=(3, 5)).zip(seed=(0, 1), work=(10, 12))
    assert [s.to_dict() for s in s2.specs()] == \
        [s.to_dict() for s in ref.specs()]


def test_study_axis_errors():
    st = tsync.Study(protocol="amo")
    with pytest.raises(ValueError, match="equal length"):
        st.zip(seed=(0, 1), lat=(1,))
    with pytest.raises(ValueError, match="empty"):
        st.grid(seed=())
    with pytest.raises(ValueError):                        # unknown field
        st.grid(n_banks=(1, 2)).specs()
    with pytest.raises(ValueError):                        # bad value, eager
        st.grid(n_cores=(8, 0)).specs()
    with pytest.raises(ValueError):
        tsync.Study.from_specs([])


def test_a_refused_spec_raises_inside_a_study():
    """A grid of fault plans, once refused, runs inside a Study and
    equals the reference's, faulted and fault-free points alike; a spec
    the run kernel does not take (a topology deeper than its levels) is
    refused by its scalars (``run_scalars``; through a Study on the card
    in the test below)."""
    def study(pkg):
        return pkg.Study(protocol="colibri", n_cores=8, cycles=120) \
            .grid(faults=({}, {"n_kill": 1, "watchdog_cyc": 16}))
    want = study(jsync).run()
    got = study(tsync).run(device="cpu")
    for g, w in zip(got, want):
        assert g.ok
        _same(g, w)
    assert got[1].faults_injected == 1 and got[0].progress_ok is None
    specs = [jsync.Spec(faults={"n_kill": 1}, n_cores=8,
                        cycles=50).to_dict()]
    assert tsync.Study.from_specs(specs).run(device="cpu")[0].ok
    from repro_torch.core import protocols, sim, workloads
    from repro_torch.kernels.engine_step import kernel as K
    from repro_torch.core.topologies import base as tbase, registry
    class Deep(tbase.Topology):
        name = "deep_levels"
        levels = tuple(tbase.LinkLevel(f"l{i}", extra_lat=1, bw_div=1)
                       for i in range(K.MAX_LEVELS + 1))
    registry.register(Deep)
    try:
        p = sim.SimParams(protocol="colibri", n_cores=8,
                          topology="deep_levels", faults={"n_kill": 1})
        with pytest.raises(NotImplementedError, match="deep_levels"):
            K.run_scalars(p, protocols.get("colibri"),
                          workloads.get(p.workload).program(p))
    finally:
        del registry._REGISTRY["deep_levels"]


class _Deep:
    """A topology deeper than the run kernel's levels, registered in the
    port's registry for the length of the block."""

    def __enter__(self):
        from repro_torch.core.topologies import base as tbase, registry
        from repro_torch.kernels.engine_step import kernel as K

        class Deep(tbase.Topology):
            name = "deep_levels"
            levels = tuple(tbase.LinkLevel(f"l{i}", extra_lat=1, bw_div=1)
                           for i in range(K.MAX_LEVELS + 1))
        registry.register(Deep)

    def __exit__(self, *exc):
        from repro_torch.core.topologies import registry
        del registry._REGISTRY["deep_levels"]


def _card_stub(monkeypatch, launched, raise_in_launch=None):
    """Study.run(device="cuda") on the CPU: a GPU reported, the library
    load skipped, and each chunk's launch recorded in ``launched`` (and
    raising ``raise_in_launch`` when given)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tsweep, "_library_load", lambda: None)

    def launch(chunk, dev, started=None):
        launched.append([p.topology for p in chunk])
        if raise_in_launch is not None:
            raise raise_in_launch
        raise AssertionError("the stub runs no chunk")
    monkeypatch.setattr(tsweep, "_sweep_group", launch)


@pytest.mark.parametrize("where", [0, 2], ids=["first", "last"])
def test_a_card_refusal_raises_from_study_run_before_any_launch(
        monkeypatch, where):
    """A point the run kernel does not take (a topology deeper than its
    levels), first or last in the grid, raises NotImplementedError from
    ``Study.run(device="cuda")`` while the grid is planned: no chunk is
    launched, and no point becomes an ``ok=False`` record."""
    launched = []
    _card_stub(monkeypatch, launched)
    topos = ["flat", "flat", "flat"]
    topos[where] = "deep_levels"
    with _Deep():
        st = tsync.Study(protocol="colibri", n_cores=8, cycles=50) \
            .zip(topology=tuple(topos), seed=(0, 1, 2))
        with pytest.raises(NotImplementedError, match="deep_levels"):
            st.run(device="cuda")
        with pytest.raises(NotImplementedError, match="deep_levels"):
            next(iter(st.stream(device="cuda")))
    assert launched == []


def test_a_refusal_in_a_launch_passes_through_the_fence(monkeypatch):
    """A NotImplementedError raised by a chunk's packing is a refusal,
    not a failed point: the isolation ladder lets it through."""
    launched = []
    _card_stub(monkeypatch, launched, NotImplementedError("refused here"))
    st = tsync.Study(protocol="colibri", n_cores=8, cycles=50) \
        .grid(seed=(0, 1))
    with pytest.raises(NotImplementedError, match="refused here"):
        st.run(device="cuda")
    assert launched == [["flat", "flat"]]


def test_study_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsync.Study(protocol="amo", n_cores=8, cycles=10).run()


def test_run_report_records_the_chunks():
    """collect(): the chunks' points add up to the study's length, one
    record per launch; to_dict has the reference's keys."""
    st = tsync.Study(protocol="amo", n_cores=8, cycles=40) \
        .grid(n_cores=(8, 16), seed=(0, 1, 2))
    with tobs.collect() as report:
        st.run(max_batch=2, device="cpu")
    assert tobs.current() is None
    assert report.n_points == len(st) == 6
    assert report.n_chunks == 4                  # 3 points a core count
    assert [c.points for c in report.chunks] == [2, 1, 2, 1]
    assert report.backend == "cpu" and report.device == "cpu"
    assert report.max_batch == 2 and report.n_devices == 1
    d = report.to_dict()
    ref = jrunreport.RunReport()
    ref.record_chunk("x", 1, 1, 0.0, 0.0, False)
    want = ref.to_dict()
    assert set(d) == set(want)
    assert set(d["chunks"][0]) == set(want["chunks"][0])
    assert report.summary().startswith("6 pts / 4 chunks on cpu")
    explicit = tobs.RunReport()
    st.run(device="cpu", report=explicit)
    assert explicit.n_points == 6 and explicit.n_chunks == 2


def test_result_error_fields():
    ok = tsync.run(protocol="amo", n_cores=8, cycles=40, device="cpu")
    assert ok.ok and ok.error is None
    bad = tsync.Result(spec=ok.spec, stats={
        "error": "RuntimeError: injected", "error_stage": "dispatch"})
    assert not bad.ok and bad.error == "RuntimeError: injected"
    assert bad.to_row()["error_stage"] == "dispatch"
    assert '"error": "RuntimeError: injected"' in bad.to_json()
    want = jsync.Result(spec=jsync.Spec.from_dict(ok.spec.to_dict()),
                        stats=dict(bad.stats))
    assert bad.to_row() == want.to_row()


def test_sync_exports():
    assert {"Study", "enable_persistent_cache"} <= set(tsync.__all__)
    assert tsync.enable_persistent_cache is tsweep.enable_persistent_cache
    assert {"RunReport", "ChunkRecord", "collect", "current"} <= \
        set(tobs.__all__)
