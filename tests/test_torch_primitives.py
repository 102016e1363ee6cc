"""The port's integer primitives against the JAX reference, exhaustively.

Every primitive here feeds the engine's state, which is held to bit
identity, so the tolerance is zero: equal values and equal dtypes.
Inputs come from seeded numpy and go to both packages.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sim as jsim
from repro.core.metrics import LAT_BINS as J_LAT_BINS
from repro.core.metrics import LAT_SUB
from repro.core.workloads.base import zipf_index as j_zipf_index
from repro_torch import convert
from repro_torch.core import metrics as tmetrics
from repro_torch.core import sim as tsim
from repro_torch.core.workloads.base import zipf_index as t_zipf_index
from jax_cache import release_compiled  # noqa: F401


# ---------------------------------------------------------------------------
# _hash: uint32 multiply with wraparound, emulated in int64
# ---------------------------------------------------------------------------

def test_hash_matches_reference_on_2_24_inputs_and_wrap_edges():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(-2**31, 2**31, 1 << 24, dtype=np.int64),
        np.arange(-2**31, -2**31 + 4096, dtype=np.int64),
        np.arange(2**31 - 4096, 2**31, dtype=np.int64),
        np.arange(-4096, 4096, dtype=np.int64)]).astype(np.int32)
    want = np.asarray(jsim._hash(jnp.asarray(x))).astype(np.int64)
    got = tsim._hash(torch.from_numpy(x.astype(np.int64))).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_hash_of_engine_sums_matches_int32_wrap():
    """The engine hashes ``iota*7919 + opc*104729 + seed``, which wraps
    int32 in the reference; the port sums exactly in int64."""
    rng = np.random.default_rng(1)
    n = 1 << 16
    iota = np.arange(n, dtype=np.int32)
    opc = rng.integers(0, 2**31, n).astype(np.int32)
    for seed in (0, 7, 2**31 - 1, -2**31):
        want = np.asarray(jsim._hash(jnp.asarray(iota) * 7919
                                     + jnp.asarray(opc) * 104729
                                     + seed)).astype(np.int64)
        got = tsim._hash(torch.from_numpy(iota.astype(np.int64)) * 7919
                         + torch.from_numpy(opc.astype(np.int64)) * 104729
                         + seed).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# network acceptance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 64, 256])
def test_accept_rotating_fair_matches_reference(n):
    rng = np.random.default_rng(n)
    for _ in range(12):
        req = rng.random(n) < rng.random()
        shift = int(rng.integers(0, n))
        rot = ((np.arange(n) + shift) % n).astype(np.int32)
        budget = int(rng.integers(1, n + 2))
        want = np.asarray(jsim.accept_rotating_fair(
            jnp.asarray(req), jnp.asarray(rot), jnp.int32(budget),
            shift=shift))
        got = tsim.accept_rotating_fair(
            torch.from_numpy(req), torch.tensor(budget, dtype=torch.int32),
            shift).numpy()
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# latency buckets: integer thresholds in place of float32 log2
# ---------------------------------------------------------------------------

@jax.jit
def _ref_bucket(v):
    # the engine's expression (core/sim.py, kernels/engine_step)
    return jnp.clip((LAT_SUB * jnp.log2(v.astype(jnp.float32) + 1.0)
                     ).astype(jnp.int32), 0, J_LAT_BINS - 1)


def test_lat_bucket_matches_reference_log2_below_2_20():
    v = np.arange(1 << 20, dtype=np.int32)
    want = np.asarray(_ref_bucket(jnp.asarray(v)))
    got = tmetrics.lat_bucket(torch.from_numpy(v)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the two values where XLA's float32 log2 falls short of the exact
    # bucket — the reason the port never computes log2
    assert want[8191] == 51 and want[32767] == 59


def test_lat_thresholds_rederived_from_reference():
    v = np.arange(1 << 20, dtype=np.int32)
    b = np.asarray(_ref_bucket(jnp.asarray(v)))
    assert np.all(np.diff(b) >= 0)
    thr = tuple(int(np.argmax(b >= k)) for k in range(J_LAT_BINS))
    assert thr == tmetrics.LAT_THRESHOLDS
    assert tmetrics.LAT_BINS == J_LAT_BINS


# ---------------------------------------------------------------------------
# zipf_index at skew 0 (Fig. 3's uniform bins)
# ---------------------------------------------------------------------------

# 43, 92, 554 and 1000 are counts where u * n_addrs + 1 rounded twice
# differs from the reference's fused multiply-add on 1-5 hashes
@pytest.mark.parametrize("n_addrs", [1, 64, 1024, 43, 92, 554, 1000])
def test_zipf_index_skew0_matches_reference_on_all_2_24_hashes(n_addrs):
    h = np.arange(1 << 24, dtype=np.uint32)
    want = np.asarray(jax.jit(lambda x: j_zipf_index(x, n_addrs, 0))(
        jnp.asarray(h)))
    got = t_zipf_index(torch.from_numpy(h.astype(np.int64)), n_addrs,
                       0).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# state conversion and import hygiene
# ---------------------------------------------------------------------------

def test_convert_round_trip_keeps_values_and_dtypes():
    rng = np.random.default_rng(3)
    tree = {"qbuf": rng.integers(-1, 9, (3, 4)).astype(np.int32),
            "resv_valid": rng.random(3) < 0.5,
            "msgs": np.asarray(7, np.int32),
            "nested": [np.arange(5, dtype=np.int32)],
            "throughput": 0.25}
    t = convert.to_torch(tree, "cpu")
    assert t["qbuf"].dtype == torch.int32
    assert t["resv_valid"].dtype == torch.bool
    assert t["msgs"].shape == ()
    assert t["throughput"] == 0.25
    back = convert.to_numpy(t)
    for k in ("qbuf", "resv_valid", "msgs"):
        assert back[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(back[k], tree[k])
    np.testing.assert_array_equal(back["nested"][0], tree["nested"][0])


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.sync, repro_torch.convert, "
            "repro_torch.serving, repro_torch.models, repro_torch.configs; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
