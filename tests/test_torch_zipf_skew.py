"""The skewed Zipf stream of the port against the reference, bit for bit.

The reference's ``zipf_index`` (``repro.core.workloads.base``) runs on
XLA's CPU build: float32 ``pow`` is the C library's ``powf`` and
``1 + u*c`` is contracted into one fused multiply-add.  Traced, as the
reference's sweep (``Study``) passes ``n_addrs`` and ``zipf_skew``, its
``1 - s`` is contracted too, so a single run (``sync.run``) and a sweep
give different streams at most skews.  The port builds each stream's
threshold table with ``powf``/``fmaf`` through ``ctypes`` and counts the
thresholds at or below a hash:

* ``zipf_index`` equals the reference's on all 2^24 hashes, in the
  constant form (jit with Python ints) and the traced form (jit with
  traced scalars), at the (n_addrs, skew) points below;
* the tables are nondecreasing and hold their own check; skew 0 and the
  log-uniform limit (skew 100) give one stream in both forms;
* ``zipf_histogram`` at skews 0/100/150/200 × colibri, lrsc and
  amo_lock equals the reference on every key through ``run`` (the
  constant form) and through ``Study`` (the traced form), where the two
  forms give different results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sync as jsync
from lock_points import assert_execute_matches_reference
from repro.core.workloads.base import zipf_index as j_zipf_index
from repro_torch import sync as tsync
from repro_torch.core import sim as tsim
from repro_torch.core.workloads import base as twl
from jax_cache import release_compiled  # noqa: F401

#: (n_addrs, zipf_skew) points held on every hash
POINTS = ((64, 100), (64, 150), (256, 150), (1024, 150), (1024, 200),
          (1000, 150), (16, 99), (64, 50))
#: the engine points' skews and protocols
SKEWS = (0, 100, 150, 200)
PROTOS = ("colibri", "lrsc", "amo_lock")


#: the 2^24 hashes in slices of this many (one compile, little memory)
SLICE = 1 << 21


def _slices():
    for lo in range(0, 1 << 24, SLICE):
        h = np.arange(lo, lo + SLICE, dtype=np.uint32)
        yield jnp.asarray(h), torch.from_numpy(h.astype(np.int64))


def _reference(n_addrs, skew, traced):
    """The reference's zipf_index jitted as a single run (constant
    scalars) or a sweep (traced scalars) traces it."""
    if traced:
        fn = jax.jit(j_zipf_index)
        return lambda h: np.asarray(fn(h, jnp.int32(n_addrs),
                                       jnp.int32(skew)))
    fn = jax.jit(lambda x: j_zipf_index(x, n_addrs, skew))
    return lambda h: np.asarray(fn(h))


@pytest.mark.parametrize("traced", [False, True], ids=["constant", "traced"])
@pytest.mark.parametrize("n_addrs,skew", POINTS)
def test_zipf_index_matches_reference_on_all_2_24_hashes(n_addrs, skew,
                                                         traced):
    ref = _reference(n_addrs, skew, traced)
    for hj, ht in _slices():
        want = ref(hj)
        got = twl.zipf_index(ht, n_addrs, skew, traced).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_addrs,skew", [(64, 150), (1000, 150),
                                          (16, 99), (16384, 200)])
def test_thresholds_are_monotone_and_hold_their_check(n_addrs, skew):
    for traced in (False, True):
        thr = twl.zipf_thresholds(n_addrs, skew, traced)
        assert thr.dtype == np.int32 and thr.shape == (n_addrs - 1,)
        assert not thr.flags.writeable
        assert np.all(np.diff(thr) >= 0)
        assert thr[0] >= 1 and thr[-1] <= twl.HASH_SPAN
        addr, _, _ = twl.zipf_address_fn(n_addrs, skew, traced)
        # every threshold is a step of the float32 function
        for k in np.random.default_rng(n_addrs).integers(0, n_addrs - 1, 64):
            t = int(thr[k])
            assert addr(t - 1) <= k
            assert t == twl.HASH_SPAN or addr(t) >= k + 1
        assert twl.zipf_thresholds(n_addrs, skew, traced) is thr  # cached


def test_forms_agree_at_skew_0_and_at_100_and_differ_elsewhere():
    ht = torch.arange(1 << 24, dtype=torch.int64)
    for n_addrs in (43, 64, 1000):
        assert torch.equal(twl.zipf_index(ht, n_addrs, 0, False),
                           twl.zipf_index(ht, n_addrs, 0, True))
        np.testing.assert_array_equal(
            twl.zipf_thresholds(n_addrs, 100, False),
            twl.zipf_thresholds(n_addrs, 100, True))
    # the reference's run and sweep streams differ here (43 hashes)
    assert not np.array_equal(twl.zipf_thresholds(64, 150, False),
                              twl.zipf_thresholds(64, 150, True))
    assert twl.zipf_factors(1000, 0) == 1000.0
    assert twl.zipf_factors(1000, 150) is None
    one = twl.zipf_index(ht[:10], 1, 150)
    assert one.dtype == torch.int32 and not one.any()


def _kw(skew, n_addrs, seed):
    return dict(workload="zipf_histogram", zipf_skew=skew, n_cores=32,
                n_addrs=n_addrs, cycles=600, seed=seed)


@pytest.mark.parametrize("proto", PROTOS)
@pytest.mark.parametrize("skew", SKEWS)
def test_run_matches_reference_key_for_key(proto, skew):
    got = assert_execute_matches_reference(
        proto, _kw(skew, 1000 if skew == 150 else 64, skew + 1))
    assert int(got["ops"].sum()) > 0


@pytest.mark.parametrize("proto", ["colibri", "lrsc"])
def test_skew_150_at_64_bins_matches_reference_key_for_key(proto):
    assert_execute_matches_reference(proto, _kw(150, 64, 7))


def _same(got, want):
    assert set(got.stats) == set(want.stats)
    for k, w in want.stats.items():
        g, w = np.asarray(got.stats[k]), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert np.array_equal(g, w), k


def test_study_matches_reference_key_for_key():
    """The Study of every engine point and two more whose seeds draw, in
    their first ops, a hash where the sweep's stream differs from the
    single run's: the port's Study equals the reference's, those two
    differ from their single runs, and skews 0 and 100 do not."""
    specs = [dict(protocol=pr, **_kw(s, 1000 if s == 150 else 64, s + 1))
             for pr in PROTOS for s in SKEWS]
    specs += [dict(protocol="lrsc", **_kw(150, 1000, 304)),
              dict(protocol="colibri", **_kw(99, 16, 77)),
              dict(protocol="lrsc", **_kw(150, 64, 7))]
    ref = jsync.Study.from_specs([jsync.Spec(**d) for d in specs]).run()
    got = tsync.Study.from_specs([tsync.Spec(**d) for d in specs]).run(
        device="cpu")
    forms_differ = 0
    for d, g, w in zip(specs, got, ref):
        assert g.ok
        _same(g, w)
        g.check()
        one = tsim.execute(tsync.Spec(**d).to_params(), device="cpu")
        live = np.asarray(g.stats["addr_ops"])[:d["n_addrs"]]
        differ = not np.array_equal(one["addr_ops"], live) or any(
            not np.array_equal(np.asarray(one[k]), np.asarray(g.stats[k]))
            for k in ("ops", "lat_hist", "msgs"))
        forms_differ += differ
        if d["zipf_skew"] in (0, 100):
            assert not differ, d
        if d["seed"] in (304, 77):
            assert differ, d
    assert forms_differ >= 2
