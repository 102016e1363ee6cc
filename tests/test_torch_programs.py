"""A program of the tests' own on the port against the reference, bit
for bit, and the premise of the run kernel's program design.

``OWN`` (``tests/program_points.py``) has local work and modify
durations that differ from step to step, a barrier step mid-program and
every address mode, so it reaches what the three registered programs do
not: each core's ``mod_dur`` is its own step's (the wake paths of the
queue protocols grant with it) and the barrier count is not the op
count.  It is registered in both registries inside each test and
removed afterwards.  Every key of the port's result equals the
reference's, for the eleven protocols and with workers.

The run kernel keeps no program counter: it derives ``pc``, ``ops`` and
``bar_cnt`` from the op count (``program_identities``), which holds
here on the reference's own results for every workload program.
"""
import pytest

from program_points import (OWN, PROTOS, assert_matches_reference,
                            own_program, program_identities)
from repro.core import sim as jsim
from repro.core import workloads as jworkloads
from jax_cache import release_compiled  # noqa: F401


@pytest.mark.parametrize("i,proto", list(enumerate(PROTOS)))
def test_own_program_matches_reference_key_for_key(i, proto):
    with own_program():
        assert_matches_reference(
            proto, OWN, n_cores=16, n_addrs=3, zipf_skew=0, cycles=800,
            seed=7 * i + 3, backoff=24, record_trace=True,
            telemetry_windows=8 * (i % 2))


def test_own_program_with_workers_matches_reference():
    with own_program():
        assert_matches_reference(
            "lrscwait", OWN, n_cores=16, n_addrs=3, zipf_skew=0,
            n_workers=3, net_bw=13, cycles=800, seed=5, record_trace=True,
            telemetry_windows=8)


def test_own_program_leaves_the_registries_as_they_were():
    from repro_torch.core import workloads as tworkloads
    before = (jworkloads.names(), tworkloads.names())
    with own_program():
        assert OWN in jworkloads.names() and OWN in tworkloads.names()
    assert (jworkloads.names(), tworkloads.names()) == before


@pytest.mark.parametrize("wl,kw", [
    ("ms_queue", dict(n_addrs=2, modify=8)),
    ("treiber_stack", dict(n_addrs=1)),
    ("barrier_phases", dict(n_addrs=1, n_workers=3)),
])
@pytest.mark.parametrize("proto", ["colibri", "lrsc", "nb_feb"])
def test_program_identities_hold_on_the_reference(proto, wl, kw):
    p = jsim.SimParams(protocol=proto, workload=wl, n_cores=16,
                       cycles=1200, backend="xla_cpu", **kw)
    res = jsim.execute(p)
    assert int(res["opc"].sum()) > 0
    program_identities(res, jworkloads.get(wl).program(p))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_own_program_is_the_tests_own():
    from own_program import OWN_FIELDS, OWN_MIN_ADDRS
    cs = _chip_smoke()
    assert (cs.OWN_PROGRAM, cs.OWN_FIELDS, cs.OWN_MIN_ADDRS) \
        == (OWN, OWN_FIELDS, OWN_MIN_ADDRS)


def test_chip_smoke_fig6_is_the_bench_queue_grid():
    """The fig6 phase runs ``benchmarks/bench_queue.py``'s grid at its
    full length (10 000 cycles): ms_queue at its scenario with the fixed
    128-cycle backoff, its protocols × core counts, one launch per core
    count."""
    import sys
    from pathlib import Path
    import repro.sync as jsync
    from repro_torch import sync as tsync
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks import bench_queue
    cs = _chip_smoke()
    assert cs.FIG6_CYCLES == 10_000
    want = [jsync.Spec(workload="ms_queue", cycles=cs.FIG6_CYCLES,
                       protocol=pr, n_cores=n, **bench_queue.KW)
            for pr in bench_queue.PROTOS for n in bench_queue.CORES]
    got = cs.fig6_specs()
    assert [g.to_dict() for g in got] == [
        tsync.Spec.from_json(w.to_json()).to_dict() for w in want]
    assert len({g.to_params().n_cores for g in got}) == len(cs.FIG6_CORES)


def test_chip_smoke_workloads_is_the_bench_workloads_grid():
    """The workloads phase runs ``benchmarks/bench_workloads.py``'s grid
    at its full length, ``zipf_histogram`` and the Zipf ladder included:
    one core count, one launch."""
    import sys
    from pathlib import Path
    import repro.sync as jsync
    from repro_torch import sync as tsync
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks import bench_workloads as bw
    cs = _chip_smoke()
    assert cs.GRID_CYCLES == 6_000
    assert cs.GRID_WORKLOADS == bw.WORKLOADS
    assert cs.GRID_ZIPF_LADDER == bw.ZIPF_LADDER
    want = [jsync.Spec(protocol=pr, workload=wl, n_cores=bw.N_CORES,
                       cycles=cs.GRID_CYCLES, seed=seed, **bw._scenario(wl))
            for wl in cs.GRID_WORKLOADS for pr in bw.PROTOS
            for seed in bw.SEEDS]
    want += [jsync.Spec(protocol=pr, workload="zipf_histogram",
                        n_cores=bw.N_CORES, cycles=cs.GRID_CYCLES,
                        **{**bw._scenario("zipf_histogram"),
                           "zipf_skew": skew})
             for pr in cs.GRID_LADDER_PROTOS for skew in bw.ZIPF_LADDER]
    got = cs.grid_specs()
    assert [g.to_dict() for g in got] == [
        tsync.Spec.from_json(w.to_json()).to_dict() for w in want]
    assert {g.to_params().n_cores for g in got} == {cs.GRID_CORES}
    labels = cs.grid_labels()
    assert labels[-6:] == [f"zipf_s{s / 100:.1f}" for _ in range(2)
                           for s in bw.ZIPF_LADDER]
    assert set(labels[:-6]) == set(bw.WORKLOADS)


def test_chip_smoke_reference_rows_are_the_reports():
    """``FIG6_REF``, ``GRID_REF`` (the Zipf ladder's rows too) and
    ``FIG3_SKEW_REF`` are the reference benchmarks' rows in the committed
    ``reports/benchmarks.json``; the 2- and 8-core Fig. 6 points are
    recomputed here with the JAX package."""
    import json
    from pathlib import Path
    import repro.sync as jsync
    cs = _chip_smoke()
    root = Path(__file__).resolve().parents[1]
    rep = json.loads((root / "reports" / "benchmarks.json").read_text())
    assert cs.FIG6_REF == {
        f"{r['protocol']}/{r['cores']}": (r["throughput"],
                                          r["jain_fairness"])
        for r in rep["fig6_queue"]["rows"]}
    assert cs.GRID_REF == {
        f"{r['workload']}/{r['protocol']}": (r["ops_per_cycle"], r["polls"])
        for r in rep["workloads_grid"]["rows"]}
    assert cs.FIG3_SKEW_REF == {
        f"{r['protocol'].split('_')[0]}/{r['bins']}": (
            r["throughput"], r["jain_fairness"], r["polls"], r["msgs"],
            r["ops"])
        for r in rep["fig3_histogram"]["rows"]
        if r["protocol"].endswith(f"_zipf{cs.FIG3_SKEW / 100:.1f}")}
    for spec in cs.fig6_specs():
        n = spec.to_params().n_cores
        if n > 8:
            continue
        r = jsync.run(jsync.Spec.from_json(spec.to_json()))
        assert (r.throughput, r.jain_fairness) \
            == cs.FIG6_REF[f"{spec.protocol.name}/{n}"]
