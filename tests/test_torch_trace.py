"""The port's trace path against the reference's, exactly.

``record_trace=True`` and ``telemetry_windows=64`` runs of
``repro_torch.sync.run`` on the CPU against ``repro.sync.run``: the four
per-cycle traces, the telemetry windows and every other result key
equal; the ``EventLog``, ``Timeseries`` and Perfetto views equal (the
exported JSON byte for byte); the exact-waits latency percentiles and
``trace_latency_hist`` (through the colibri_scatter op) equal; the
workload check passes with the trace; traced ``Result`` JSON loads in
both packages.  With both features off, the result keys stay those of
an untraced run.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.sync as jsync
from repro.core import metrics as jmetrics
from repro.core import sim as jsim
from repro.obs import perfetto as jperfetto
from repro_torch import sync as tsync
from repro_torch.core import metrics as tmetrics
from repro_torch.core import sim as tsim
from repro_torch.obs import perfetto as tperfetto
from repro_torch.obs.schema import STATE_NAMES
from jax_cache import release_compiled  # noqa: F401

TRACE_KEYS = {"trace_step", "trace_wait", "trace_state", "trace_qlen"}
FEATURES = dict(record_trace=True, telemetry_windows=64, cycles=4000)

#: the reference's own trace point (tests/test_kernels.py:77) and 64-core
#: points at one hot bin and 64 bins; uniform bins (zipf_skew=0)
POINTS = {
    "colibri_rmw_32x4": dict(protocol="colibri", n_cores=32, n_addrs=4),
    "lrsc_rmw_32x4": dict(protocol="lrsc", n_cores=32, n_addrs=4, seed=1),
    "colibri_zipf_64x1": dict(protocol="colibri", workload="zipf_histogram",
                              zipf_skew=0, n_cores=64, n_addrs=1),
    "lrsc_zipf_64x1": dict(protocol="lrsc", workload="zipf_histogram",
                           zipf_skew=0, n_cores=64, n_addrs=1),
    "lrscwait_zipf_64x64": dict(protocol="lrscwait",
                                workload="zipf_histogram", zipf_skew=0,
                                n_cores=64, n_addrs=64, seed=2),
    "amo_rmw_64x64": dict(protocol="amo", n_cores=64, n_addrs=64, seed=3),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(port, reference) Results of one traced point, run once."""
    kw = dict(POINTS[name], **FEATURES)
    return (tsync.run(tsync.Spec(**kw), device="cpu"),
            jsync.run(jsync.Spec(**kw)))


def _assert_stats_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, (k, g, w)


@pytest.mark.parametrize("name", sorted(POINTS))
def test_traces_telemetry_and_results_equal(name):
    got, want = _pair(name)
    assert TRACE_KEYS | {"tele"} <= set(got.stats)
    _assert_stats_equal(got.stats, want.stats)


@pytest.mark.parametrize("name", sorted(POINTS))
def test_event_log_equal(name):
    got, want = (r.events() for r in _pair(name))
    assert [dataclasses.astuple(s) for s in got.spans()] \
        == [dataclasses.astuple(s) for s in want.spans()]
    gc, wc = got.completions(), want.completions()
    assert set(gc) == set(wc)
    for k in wc:
        np.testing.assert_array_equal(gc[k], wc[k], err_msg=k)
    for code in STATE_NAMES:
        np.testing.assert_array_equal(got.span_counts(code),
                                      want.span_counts(code))
        np.testing.assert_array_equal(got.time_in_state(code),
                                      want.time_in_state(code))


@pytest.mark.parametrize("name", sorted(POINTS))
def test_timeseries_equal(name):
    got, want = (r.timeseries() for r in _pair(name))
    assert got.to_dict() == want.to_dict()
    np.testing.assert_array_equal(got.queue_depth_mean,
                                  want.queue_depth_mean)


@pytest.mark.parametrize("name", sorted(POINTS))
def test_perfetto_export_is_byte_identical(name, tmp_path):
    got, want = _pair(name)
    assert tperfetto.to_trace_events(got) == jperfetto.to_trace_events(want)
    tp = tperfetto.export(got, str(tmp_path / "port.json"))
    jp = jperfetto.export(want, str(tmp_path / "ref.json"))
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name", sorted(POINTS))
def test_latency_percentiles_come_from_the_exact_waits(name):
    got, want = _pair(name)
    lp = tmetrics.latency_percentiles(got.stats)
    assert lp == jmetrics.latency_percentiles(want.stats)
    waits = np.sort(got["trace_wait"][got["trace_wait"] >= 0])
    assert lp["lat_p50"] == float(waits[int(np.ceil(0.5 * waits.size)) - 1])
    assert (got.lat_p50, got.lat_p95) == (want.lat_p50, want.lat_p95)


@pytest.mark.parametrize("name", sorted(POINTS))
def test_trace_latency_hist_equals_the_reference(name):
    got, want = _pair(name)
    h = tmetrics.trace_latency_hist(got.stats, device="cpu")
    assert h.dtype == np.int32
    np.testing.assert_array_equal(h, jmetrics.trace_latency_hist(want.stats))
    np.testing.assert_array_equal(
        h, tmetrics.trace_latency_hist(got.stats, use_kernel=False))
    assert int(h.sum()) == got.atomics_total


@pytest.mark.parametrize("name", sorted(POINTS))
def test_check_passes_with_the_trace(name):
    got, want = _pair(name)
    assert got.check() == want.check()


@pytest.mark.parametrize("name", sorted(POINTS))
def test_traced_result_json_loads_both_ways(name):
    got, want = _pair(name)
    assert got.to_json() == want.to_json()
    assert jsync.Result.from_json(got.to_json()).metrics() == got.metrics()
    back = tsync.Result.from_json(want.to_json())
    assert back.metrics() == want.metrics()
    assert back.spec.to_params().record_trace


def test_trace_latency_hist_buckets_as_the_reference_at_8191_and_32767():
    """The reference's trace histogram uses numpy's float32 log2 (buckets
    52 and 60), not its engine's rounding (51 and 59)."""
    waits = np.full((4, 3), -1, np.int32)
    waits[0, 0], waits[1, 2], waits[3, 1] = 8191, 32767, 7
    res = {"trace_wait": waits}
    want = jmetrics.trace_latency_hist(res)
    got = tmetrics.trace_latency_hist(res, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert set(np.flatnonzero(got)) == {52, 60, 12}
    assert tmetrics.lat_bucket(torch.tensor([8191, 32767],
                                            dtype=torch.int32)).tolist() \
        == [51, 59]


def test_trace_latency_hist_of_an_empty_trace():
    res = {"trace_wait": np.full((5, 2), -1, np.int32)}
    np.testing.assert_array_equal(
        tmetrics.trace_latency_hist(res, device="cpu"),
        jmetrics.trace_latency_hist(res))


def test_trace_latency_hist_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = {"trace_wait": np.array([[3, -1]], np.int32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmetrics.trace_latency_hist(res)


def test_features_off_leave_the_result_keys_as_they_were():
    kw = dict(protocol="colibri", n_cores=8, n_addrs=2, cycles=300)
    base = tsim.execute(tsim.SimParams(**kw), device="cpu")
    assert set(base) == set(jsim.execute(jsim.SimParams(
        backend="xla_cpu", **kw)))
    assert not (TRACE_KEYS | {"tele"}) & set(base)
    traced = tsim.execute(tsim.SimParams(record_trace=True, **kw),
                          device="cpu")
    assert set(traced) == set(base) | TRACE_KEYS
    tele = tsim.execute(tsim.SimParams(telemetry_windows=8, **kw),
                        device="cpu")
    assert set(tele) == set(base) | {"tele"}
    for k, v in base.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(traced[k], v, err_msg=k)
            np.testing.assert_array_equal(tele[k], v, err_msg=k)


def test_views_raise_without_their_feature():
    r = tsync.run(protocol="amo", n_cores=8, cycles=100, device="cpu")
    with pytest.raises(ValueError, match="telemetry_windows"):
        r.timeseries()
    with pytest.raises(ValueError, match="record_trace"):
        r.events()


@pytest.mark.parametrize("field,value", [("telemetry_windows", -1),
                                         ("telemetry_windows", 2.0),
                                         ("record_trace", 1)])
def test_simparams_validates_the_feature_fields(field, value):
    for params in (tsim.SimParams, jsim.SimParams):
        with pytest.raises(ValueError, match=field):
            params(**{field: value})
