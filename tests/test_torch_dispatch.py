"""The port's colibri ordered-commit primitives (``repro_torch.core.
dispatch``) against the reference's (``repro.core.dispatch``).

Twins of ``tests/test_dispatch.py`` (its hypothesis properties, here on
numpy-seeded cases, since the property suites skip where hypothesis is
missing) and ``tests/test_dispatch_reduce.py``.  Integers (queue
positions, counts, ``keep``, the dispatch table and ``valid``, the
histogram) must be equal to the reference's; float sums within
``tests/test_dispatch.py``'s 1e-4 / 1e-3 (both add in f32 along the
sorted order, by cumulative sums that may associate differently); max
and min exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as JD
from repro_torch.core import dispatch as D


def _case(seed):
    """(keys, values, bins) of a seeded random size, as the reference's
    hypothesis strategy draws them: 1-300 keys into 1-40 bins, values in
    [-100, 100]."""
    rng = np.random.default_rng(seed)
    n, bins = int(rng.integers(1, 301)), int(rng.integers(1, 41))
    keys = rng.integers(0, bins, n).astype(np.int32)
    vals = rng.uniform(-100, 100, n).astype(np.float32)
    return keys, vals, bins


def _reduce_cases():
    """``tests/test_dispatch_reduce.py``'s cases."""
    rng = np.random.RandomState(42)
    for n, bins in [(1, 1), (7, 3), (50, 8), (500, 40), (300, 17)]:
        keys = rng.randint(0, bins, size=n).astype(np.int32)
        vals = rng.uniform(-100, 100, size=n).astype(np.float32)
        yield keys, vals, bins
    keys = rng.randint(0, 5, size=200).astype(np.int32)
    vals = rng.uniform(-50, 50, size=200).astype(np.float32)
    yield keys, vals, 16
    yield np.full(64, 9, np.int32), np.arange(64, dtype=np.float32), 32


SEEDS = range(8)


@pytest.mark.parametrize("seed", SEEDS)
def test_queue_positions_equal_the_reference(seed):
    keys, _, bins = _case(seed)
    want_qp, want_counts = JD.queue_positions(jnp.asarray(keys), bins)
    qp, counts = D.queue_positions(torch.from_numpy(keys), bins)
    assert qp.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(qp.numpy(), np.asarray(want_qp))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    # FIFO: arrival order is queue order in every bin
    for b in range(bins):
        idx = np.where(keys == b)[0]
        assert (qp.numpy()[idx] == np.arange(len(idx))).all()


@pytest.mark.parametrize("cap", [1, 3, 8, 16])
@pytest.mark.parametrize("seed", SEEDS)
def test_dispatch_indices_equal_the_reference(seed, cap):
    """The (bins, capacity) table, ``valid`` and ``keep`` equal the
    reference's, drops included (the oldest ``cap`` requests win); each
    kept request sits in exactly one slot of its own bin."""
    keys, _, bins = _case(seed)
    want_src, want_valid, want_d = JD.dispatch_indices(jnp.asarray(keys),
                                                       bins, cap)
    src, valid, d = D.dispatch_indices(torch.from_numpy(keys), bins, cap)
    assert src.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(src.numpy(), np.asarray(want_src))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(d.keep.numpy(), np.asarray(want_d.keep))
    np.testing.assert_array_equal(d.queue_pos.numpy(),
                                  np.asarray(want_d.queue_pos))
    occupants = src.numpy()[valid.numpy()]
    assert len(np.unique(occupants)) == len(occupants) == int(d.keep.sum())
    for b in range(bins):
        assert (keys[src.numpy()[b][valid.numpy()[b]]] == b).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_dispatch_without_capacity_keeps_all(seed):
    keys, _, bins = _case(seed)
    d = D.dispatch(torch.from_numpy(keys), bins)
    want = JD.dispatch(jnp.asarray(keys), bins)
    assert bool(d.keep.all())
    np.testing.assert_array_equal(d.counts.numpy(), np.asarray(want.counts))


@pytest.mark.parametrize("seed", SEEDS)
def test_ordered_segment_sum_matches_the_reference(seed):
    keys, vals, bins = _case(seed)
    want = JD.ordered_segment_sum(jnp.asarray(keys), jnp.asarray(vals), bins)
    got = D.ordered_segment_sum(torch.from_numpy(keys),
                                torch.from_numpy(vals), bins)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    oracle = D.lrsc_scatter_add(torch.from_numpy(keys),
                                torch.from_numpy(vals), bins)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("seed", SEEDS)
def test_roundtrip_combine_matches_the_reference(seed):
    """dispatch -> buffer -> ``combine_from_slots`` gives back each
    request's value (no drops), weighted, as the reference does."""
    keys, vals, bins = _case(seed)
    cap = len(keys)
    src, valid, d = D.dispatch_indices(torch.from_numpy(keys), bins, cap)
    payload = torch.where(valid[..., None],
                          torch.from_numpy(vals)[torch.clamp(
                              src, max=len(vals) - 1).long()][..., None],
                          torch.zeros(()))
    w = np.random.default_rng(seed).uniform(0, 1, len(keys)).astype(
        np.float32)
    back = D.combine_from_slots(payload, torch.from_numpy(keys), d.queue_pos,
                                d.keep, torch.from_numpy(w))
    jsrc, jvalid, jd = JD.dispatch_indices(jnp.asarray(keys), bins, cap)
    jpayload = jnp.where(jvalid[..., None],
                         jnp.asarray(vals)[jnp.minimum(jsrc, len(vals) - 1)][
                             ..., None], 0.0)
    want = JD.combine_from_slots(jpayload, jnp.asarray(keys), jd.queue_pos,
                                 jd.keep, jnp.asarray(w))
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    np.testing.assert_allclose(back.numpy()[:, 0], vals * w, rtol=1e-6)


def test_combine_zeroes_dropped_requests():
    keys = np.array([0, 0, 0, 1], np.int32)
    src, valid, d = D.dispatch_indices(torch.from_numpy(keys), 2, 2)
    buf = torch.arange(4, dtype=torch.float32).reshape(2, 2, 1) + 1
    out = D.combine_from_slots(buf, torch.from_numpy(keys), d.queue_pos,
                               d.keep)
    np.testing.assert_array_equal(out[:, 0].numpy(), [1.0, 2.0, 0.0, 3.0])


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_segment_reduce_matches_the_reference(op):
    for keys, vals, bins in _reduce_cases():
        want = JD.ordered_segment_reduce(jnp.asarray(keys),
                                         jnp.asarray(vals), bins, op=op)
        got = D.ordered_segment_reduce(torch.from_numpy(keys),
                                       torch.from_numpy(vals), bins, op=op)
        if op == "add":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-3)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op,ident", [("max", -np.inf), ("min", np.inf)])
def test_segment_reduce_empty_bins_get_identity(op, ident):
    keys = torch.tensor([0, 0, 3], dtype=torch.int32)
    vals = torch.tensor([2.0, 7.0, -1.0])
    out = D.ordered_segment_reduce(keys, vals, 6, op=op).numpy()
    occupied = {0: 7.0 if op == "max" else 2.0, 3: -1.0}
    for b in range(6):
        assert out[b] == occupied.get(b, ident)
    empty = D.ordered_segment_reduce(torch.zeros(0, dtype=torch.int32),
                                     torch.zeros(0), 4, op=op)
    assert (empty.numpy() == ident).all()


def test_histogram_equals_the_reference_and_bincount():
    keys = np.random.RandomState(0).randint(0, 64, size=5000).astype(np.int32)
    got = D.histogram(torch.from_numpy(keys), 64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JD.histogram(jnp.asarray(keys),
                                                          64)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(keys, minlength=64))
