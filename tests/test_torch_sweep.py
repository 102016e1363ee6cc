"""The port's batched sweep (``repro_torch.core.sweep``) on the CPU, the
twin of ``tests/test_sweep.py``.

``sweep_params(..., device="cpu")`` runs the plain loop point by point
with each point's banks at the power-of-two bucket of its ``n_addrs``;
it must equal the reference's ``repro.core.sweep.sweep_params`` on every
key (shapes and bucket padding included), and the port's own single run
on every key (bank arrays on their live rows, the padded rows at the
initial bank state), however the points are chunked.  Also: the grid
order, the refused axis and ``max_batch``, the deprecation warnings,
``STATIC_FIELDS``, one host copy per chunk, and the failure-isolation
ladder.  The card's path (one launch per core count) is held to the
same results by ``chip_smoke.py``'s sweep phase and
``tests/test_torch_gpu.py``.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import sim as jsim
from repro.core import sweep as jsweep
from repro_torch.core import protocols as tprotocols
from repro_torch.core import sim as tsim
from repro_torch.core import sweep as tsweep
from repro_torch.core.sim import SimParams
from jax_cache import release_compiled  # noqa: F401

#: the per-bank arrays a sweep pads to the bucket, with their bank axis
BANK_AXIS = {"addr_ops": 0, "qbuf": 0, "qhead": 0, "qlen": 0,
             "wake_tmr": 0, "resv_core": 0, "resv_valid": 0,
             "trace_qlen": 1}


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **kw)


def _ref(kws):
    return jsweep.sweep_params([jsim.SimParams(**kw) for kw in kws])


def _port(kws, **kw):
    return tsweep.sweep_params([SimParams(**k) for k in kws], device="cpu",
                               **kw)


def assert_equals_reference(got: dict, want: dict) -> None:
    """Every key of the reference's swept dict, values, dtypes and
    shapes (the bucket padding) included."""
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert np.array_equal(g, w), k


def assert_equals_single_run(got: dict, p: SimParams) -> None:
    """Every key of the port's single run; bank arrays on their live
    rows, the rows past them at the protocol's initial bank state."""
    one = tsim.execute(p, device="cpu")
    assert list(got) == list(one)
    bucket = tsweep._bucket_a(p.n_addrs)
    proto = tprotocols.get(p.protocol)
    init = proto.init_bank_state(p, bucket, p.n_cores,
                                 proto.q_cap(p, p.n_cores), "cpu")
    for k, w in one.items():
        g = np.asarray(got[k])
        if k not in BANK_AXIS:
            assert np.array_equal(g, np.asarray(w)), k
            continue
        ax = BANK_AXIS[k]
        assert g.shape[ax] == bucket, k
        live = np.take(g, range(p.n_addrs), axis=ax)
        pad = np.take(g, range(p.n_addrs, bucket), axis=ax)
        assert np.array_equal(live, w), k
        want_pad = (np.take(init[k].numpy(), range(p.n_addrs, bucket),
                            axis=ax) if k in init else np.zeros_like(pad))
        assert np.array_equal(pad, want_pad), k


MIXED = [
    dict(protocol="colibri", n_cores=16, cycles=250, n_addrs=1),
    dict(protocol="colibri", n_cores=16, cycles=250, n_addrs=8, lat=3,
         seed=1),
    dict(protocol="lrsc", n_cores=16, cycles=250, n_addrs=3, work=6),
    dict(protocol="lrsc", n_cores=16, cycles=250, n_addrs=1, backoff=128,
         backoff_exp=1, seed=-5),
]


def test_sweep_equals_reference_and_single_run_mixed_axes():
    """Two protocols, contention, latency, work, backoff and seeds in one
    launch group; n_addrs=3 runs at the 4-bank bucket."""
    got = _port(MIXED)
    for kw, g, w in zip(MIXED, got, _ref(MIXED)):
        assert_equals_reference(g, w)
        assert_equals_single_run(g, SimParams(**kw))


def test_sweep_equals_reference_queue_workers_traced():
    """lrscwait with workers and head-of-line blocking (the Fig. 5
    regime), a traced and telemetered point at a padded bucket."""
    kws = [dict(protocol="lrscwait", n_cores=16, cycles=250, n_addrs=1,
                n_workers=w, net_bw=13, hol_block=16) for w in (0, 4)]
    kws.append(dict(protocol="lrscwait", n_cores=16, cycles=250,
                    n_addrs=3, q_slots=4, record_trace=True,
                    telemetry_windows=4, seed=2))
    got = _port(kws)
    for kw, g, w in zip(kws, got, _ref(kws)):
        assert_equals_reference(g, w)
        assert_equals_single_run(g, SimParams(**kw))
    assert got[1]["worker_rate"] > 0


def test_sweep_mixed_worker_axis_and_chunking_identical():
    """A worker/worker-free mix split by chunking, and max_batch 1, 2
    and 3: the same bits as one chunk."""
    kws = [dict(protocol="colibri", n_cores=16, n_addrs=a, cycles=150,
                n_workers=w, seed=s)
           for a, w, s in [(1, 8, 0), (1, 0, 1), (4, 4, 2), (2, 0, 3),
                           (16, 0, 4)]]
    whole = _port(kws)
    for mb in (1, 2, 3):
        for g, w in zip(_port(kws, max_batch=mb), whole):
            assert_equals_reference(g, w)
    for kw, g in zip(kws, whole):
        assert_equals_single_run(g, SimParams(**kw))


def test_sweep_grid_product_order():
    base = SimParams(protocol="amo", n_cores=16, cycles=200)
    res = _quiet(tsweep.sweep_grid, base, n_addrs=(1, 4), seed=(0, 1),
                 device="cpu")
    assert [(r["_config"].n_addrs, r["_config"].seed) for r in res] == \
        [(1, 0), (1, 1), (4, 0), (4, 1)]
    for r in res:
        assert_equals_single_run({k: v for k, v in r.items()
                                  if k != "_config"}, r["_config"])


def test_sweep_rejects_non_sweepable_axis_and_bad_max_batch():
    with pytest.raises(ValueError, match="not sweepable"):
        _quiet(tsweep.sweep_grid, SimParams(), n_cores=(8, 16),
               device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        _quiet(tsweep.sweep, [SimParams(n_cores=8, cycles=10)],
               max_batch=0, device="cpu")


def test_legacy_entry_points_emit_deprecation_warning():
    p = SimParams(protocol="amo", n_cores=8, cycles=20)
    with pytest.warns(DeprecationWarning, match="repro_torch.sync.Study"):
        tsweep.sweep([p], device="cpu")
    with pytest.warns(DeprecationWarning, match="grid"):
        tsweep.sweep_grid(p, seed=(0,), device="cpu")


def test_static_fields_cover_simparams():
    fields = {f.name for f in dataclasses.fields(SimParams)}
    assert fields == set(tsweep.STATIC_FIELDS) | set(tsim.DYN_FIELDS)
    assert tsweep.STATIC_FIELDS == jsweep.STATIC_FIELDS
    assert tsim.DYN_FIELDS == jsim.DYN_FIELDS
    assert tsweep.DEFAULT_MAX_BATCH == jsweep.DEFAULT_MAX_BATCH
    for a in range(1, 70):
        assert tsweep._bucket_a(a) == jsweep._bucket_a(a)


def test_sweep_one_transfer_per_chunk(monkeypatch):
    """One host copy per chunk (``_to_host``, the twin of the
    reference's one ``jax.device_get``): one launch group of 12 points
    is one copy, and at max_batch=5 three."""
    calls = []
    real = tsweep._to_host
    monkeypatch.setattr(tsweep, "_to_host",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.delenv("REPRO_SWEEP_MAX_BATCH", raising=False)
    base = SimParams(protocol="amo", n_cores=8, cycles=40)
    pts = [dataclasses.replace(base, n_addrs=a, seed=s)
           for a in (3, 9) for s in range(6)]
    res = tsweep.sweep_params(pts, device="cpu")
    assert len(calls) == 1
    calls.clear()
    res5 = tsweep.sweep_params(pts, max_batch=5, device="cpu")
    assert len(calls) == 3
    for a, b in zip(res, res5):
        assert_equals_reference(a, b)
    calls.clear()
    monkeypatch.setenv("REPRO_SWEEP_MAX_BATCH", "4")
    tsweep.sweep_params(pts, device="cpu")
    assert len(calls) == 3


def test_simulate_batch_pads_banks_to_the_bucket():
    ps = [SimParams(protocol=pr, n_cores=8, cycles=50, n_addrs=a, seed=a)
          for pr, a in (("lrsc", 5), ("lrscwait", 3), ("amo", 2))]
    for p, out in zip(ps, tsim.simulate_batch(ps, "cpu")):
        bucket = tsweep._bucket_a(p.n_addrs)
        assert out["addr_ops"].shape == (bucket,)
        want = tsim._simulate_plain(p, "cpu", banks=bucket)
        assert all(torch.equal(out[k], w) for k, w in want.items())


def test_sweep_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsweep.sweep_params([SimParams(n_cores=8, cycles=10)])


def test_enable_persistent_cache_names_the_build_directory(tmp_path):
    from repro_torch.kernels import _build
    assert tsweep.enable_persistent_cache() == str(_build.build_dir())
    assert tsweep.enable_persistent_cache(str(_build.build_dir())) \
        == str(_build.build_dir())
    with pytest.raises(ValueError, match="caches its CUDA libraries"):
        tsweep.enable_persistent_cache(str(tmp_path))


# ---------------------------------------------------------------------------
# the failure-isolation ladder
# ---------------------------------------------------------------------------

ISO = [SimParams(protocol="lrscwait", n_cores=8, n_addrs=4, cycles=60,
                 seed=s) for s in range(6)]


def test_poisoned_chunk_isolated(monkeypatch):
    """A launch that raises for one point: bisected down to it; it
    becomes the one error record and every other point is unchanged."""
    clean = tsweep.sweep_params(ISO, device="cpu")
    orig = tsweep._sweep_group

    def poisoned(chunk, device, started=None):
        if any(p.seed == 4 for p in chunk):
            raise RuntimeError("injected launch failure")
        return orig(chunk, device, started)

    monkeypatch.setattr(tsweep, "_sweep_group", poisoned)
    got = dict(tsweep.sweep_iter(ISO, device="cpu"))
    assert sorted(got) == list(range(len(ISO)))
    assert [i for i, r in got.items() if "error" in r] == [4]
    assert got[4]["error"] == "RuntimeError: injected launch failure"
    assert got[4]["error_stage"] == "dispatch"
    for i, r in got.items():
        if i != 4:
            assert_equals_reference(r, clean[i])


def test_nonfinite_point_becomes_error_record(monkeypatch):
    """Points whose throughput comes back NaN (here: an odd op count)
    get their solo retry, then a "nonfinite" error record; the others
    are unchanged."""
    clean = tsweep.sweep_params(ISO, device="cpu")
    odd = [int(r["ops"].sum()) % 2 == 1 for r in clean]
    assert any(odd) and not all(odd)
    orig = tsweep.derive_metrics

    def nanify(res, n_workers, cycles, energy_fit=None):
        out = orig(res, n_workers, cycles, energy_fit=energy_fit)
        if int(np.asarray(res["ops"]).sum()) % 2:
            out["throughput"] = float("nan")
        return out

    monkeypatch.setattr(tsweep, "derive_metrics", nanify)
    for r, o, c in zip(tsweep.sweep_params(ISO, device="cpu"), odd, clean):
        if o:
            assert r["error_stage"] == "nonfinite"
        else:
            assert_equals_reference(r, c)


def test_metric_failure_solo_retried(monkeypatch):
    """A derivation that fails once per point succeeds on the solo
    retry: every point comes back whole."""
    orig = tsweep.derive_metrics
    seen = set()

    def flaky(res, n_workers, cycles, energy_fit=None):
        key = int(np.asarray(res["msgs"]))
        if key not in seen:
            seen.add(key)
            raise ValueError("first derivation fails")
        return orig(res, n_workers, cycles, energy_fit=energy_fit)

    monkeypatch.setattr(tsweep, "derive_metrics", flaky)
    got = tsweep.sweep_params(ISO, device="cpu")
    monkeypatch.setattr(tsweep, "derive_metrics", orig)
    for g, w in zip(got, tsweep.sweep_params(ISO, device="cpu")):
        assert_equals_reference(g, w)
