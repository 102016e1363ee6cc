"""chip_smoke.py's trace-phase reference values, recomputed with JAX.

``chip_smoke.py`` holds the port's traced full-width points on the GPU
against embedded values (``TRACE_REF``); here the reference package
recomputes every one of them (``repro.sync.run`` on ``xla_cpu``,
``repro.core.metrics.trace_latency_hist``, ``repro.obs``), so they
cannot drift.  Also here: ``trace_record`` gives the same record for the
port's and the reference's result of one small point, and the
scatter_kernel phase covers the trace path's shapes.
"""
import importlib.util
from pathlib import Path

import pytest

import repro.sync as jsync
from repro.core import metrics as jmetrics
from repro.obs import perfetto as jperfetto
from repro_torch import sync as tsync
from repro_torch.core import metrics as tmetrics
from repro_torch.obs import perfetto as tperfetto
from jax_cache import release_compiled  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _reference_record(cs, spec, hashed, tmp_path):
    ref = jsync.run(jsync.Spec.from_json(spec.to_json()).replace(
        backend="xla_cpu"))
    doc = None
    if hashed:
        doc = Path(jperfetto.export(ref, str(tmp_path / "ref.json"))
                   ).read_bytes()
    return cs.trace_record(ref.stats, ref.events(),
                           jmetrics.trace_latency_hist(ref.stats), doc)


@pytest.mark.parametrize("point", CS.TRACE_POINTS,
                         ids=lambda p: "/".join(map(str, p)))
def test_chip_smoke_trace_values_match_the_reference(point, tmp_path):
    name, n, bins = point
    got = _reference_record(CS, CS.trace_spec(name, n, bins),
                            point in CS.PERFETTO_HASHED, tmp_path)
    assert got == CS.TRACE_REF[f"{name}/{n}/{bins}"]


def test_trace_ref_covers_the_trace_points_and_agrees_untraced():
    """Tracing changes no result: each traced point's summary equals the
    reference's untraced run of the same point (TRACE_CYCLES)."""
    cs = CS
    assert set(cs.TRACE_REF) == {f"{p}/{n}/{b}"
                                 for p, n, b in cs.TRACE_POINTS}
    assert set(cs.PERFETTO_HASHED) <= set(cs.TRACE_POINTS)
    hashed = {f"{p}/{n}/{b}" for p, n, b in cs.PERFETTO_HASHED}
    for name, n, bins in cs.TRACE_POINTS:
        key = f"{name}/{n}/{bins}"
        rec = cs.TRACE_REF[key]
        spec = cs.full_width_spec(name, n, bins).replace(
            cycles=cs.TRACE_CYCLES)
        untraced = cs.full_width_summary(jsync.run(
            jsync.Spec.from_json(spec.to_json()).replace(
                backend="xla_cpu")).stats)
        assert {k: rec[k] for k in untraced} == untraced
        assert sum(rec["trace_latency_hist"]) == rec["ops"]
        assert ("perfetto_sha256" in rec) == (key in hashed)


def test_scatter_phase_covers_the_trace_path_shapes():
    cs = CS
    trace_shapes = {(rec["ops"], 64, 1, "float32")
                    for rec in cs.TRACE_REF.values()}
    assert trace_shapes <= set(cs.SCATTER_SHAPES)
    assert cs.SCATTER_HEAD == max(trace_shapes)


def test_trace_record_is_the_same_for_both_packages(tmp_path):
    cs = CS
    spec = cs.full_width_spec("lrsc", 32, 2).replace(
        cycles=1500, record_trace=True, telemetry_windows=64)
    port = tsync.run(spec, device="cpu")
    doc = Path(tperfetto.export(port, str(tmp_path / "port.json"))
               ).read_bytes()
    got = cs.trace_record(port.stats, port.events(),
                          tmetrics.trace_latency_hist(port.stats,
                                                      device="cpu"), doc)
    assert got == _reference_record(cs, spec, True, tmp_path)
    assert got["spans"]["BACKOFF"] > 0
