"""The port's colibri_scatter ops against the reference's Pallas kernel.

On the CPU, ``repro_torch.kernels.colibri_scatter`` takes its plain
version (``index_add_``); the reference runs its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it.  Both get the same
numpy-seeded keys and values.  Float sums are held to
``tests/test_kernels.py``'s tolerances (the two sum in different
orders); histogram counts must be exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import colibri_scatter as jcs
from repro.kernels.colibri_scatter.ref import scatter_add_ref as j_ref
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels import colibri_scatter as tcs
from repro_torch.kernels.colibri_scatter.kernel import scatter_commit_cuda
from repro_torch.kernels.engine_step import kernel as es_kernel

SHAPES = [(100, 7, 1), (1000, 64, 8), (2048, 300, 16), (513, 1, 4)]
#: dtype -> (rtol, atol) of tests/test_kernels.py
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (0.15, 1.5)}


def _inputs(t, bins, d, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, bins, t).astype(np.int32)
    vals = rng.standard_normal((t, d)).astype(np.float32)
    return keys, vals


def _both(vals, dtype):
    """The same values in ``dtype`` for each package (both round f32 to
    bf16 to nearest even)."""
    return (jnp.asarray(vals, getattr(jnp, dtype)),
            torch.from_numpy(vals).to(getattr(torch, dtype)))


@pytest.mark.parametrize("t,bins,d", SHAPES)
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_scatter_add_matches_the_pallas_kernel(t, bins, d, dtype):
    keys, vals = _inputs(t, bins, d, seed=[t, bins, d])
    jv, tv = _both(vals, dtype)
    want = np.asarray(jcs.colibri_scatter_add(jnp.asarray(keys), jv, bins),
                      np.float32)
    got = tcs.colibri_scatter_add(torch.from_numpy(keys), tv, bins)
    assert got.dtype == tv.dtype and tuple(got.shape) == (bins, d)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    exact = np.asarray(j_ref(jnp.asarray(keys), jv.astype(jnp.float32),
                             bins))
    np.testing.assert_allclose(got.float().numpy(), exact, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("t,bins", [(100, 7), (1000, 64), (513, 1),
                                    (2048, 300), (150_414, 64)])
def test_histogram_is_exact(t, bins):
    keys, _ = _inputs(t, bins, 1, seed=[t, bins])
    want = np.asarray(jcs.colibri_histogram(jnp.asarray(keys), bins))
    tk = torch.from_numpy(keys)
    got = tcs.colibri_histogram(tk, bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(keys, minlength=bins))
    assert torch.equal(got, tcs.histogram_ref(tk, bins))
    assert torch.equal(got, torch.bincount(tk, minlength=bins).int())


@pytest.mark.parametrize("bins", [7, 64, 300])
def test_keys_equal_to_num_bins_are_dropped(bins):
    keys, vals = _inputs(500, bins, 3, seed=bins)
    keys[::5] = bins
    want = np.asarray(jcs.colibri_scatter_add(jnp.asarray(keys),
                                              jnp.asarray(vals), bins))
    got = tcs.colibri_scatter_add(torch.from_numpy(keys),
                                  torch.from_numpy(vals), bins)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    kept = keys[keys < bins]
    np.testing.assert_array_equal(
        tcs.colibri_histogram(torch.from_numpy(keys), bins).numpy(),
        np.bincount(kept, minlength=bins))
    np.testing.assert_array_equal(
        np.asarray(jcs.colibri_histogram(jnp.asarray(keys), bins)),
        np.bincount(kept, minlength=bins))


def test_one_dimensional_vals_are_squeezed():
    keys, vals = _inputs(300, 11, 1, seed=9)
    v1 = vals[:, 0]
    want = np.asarray(jcs.colibri_scatter_add(jnp.asarray(keys),
                                              jnp.asarray(v1), 11))
    got = tcs.colibri_scatter_add(torch.from_numpy(keys),
                                  torch.from_numpy(v1), 11)
    assert tuple(got.shape) == (11,) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    two_d = tcs.colibri_scatter_add(torch.from_numpy(keys),
                                    torch.from_numpy(vals), 11)
    assert torch.equal(two_d[:, 0], got)


def test_empty_stream_gives_zeros():
    got = tcs.colibri_scatter_add(torch.zeros(0, dtype=torch.int32),
                                  torch.zeros((0, 4)), 5)
    assert torch.equal(got, torch.zeros((5, 4)))
    assert torch.equal(tcs.colibri_histogram(
        torch.zeros(0, dtype=torch.int32), 5),
        torch.zeros(5, dtype=torch.int32))


def test_cpu_path_launches_no_kernel():
    before = LAUNCHES["colibri_scatter"]
    tcs.colibri_histogram(torch.arange(10, dtype=torch.int32) % 3, 3)
    assert LAUNCHES["colibri_scatter"] == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper checks its inputs before it builds or launches
    anything; CPU tensors go to the plain version, never to it."""
    with pytest.raises(ValueError, match="CUDA"):
        scatter_commit_cuda(torch.zeros(4, dtype=torch.int32),
                            torch.zeros((4, 1)), 3)


def test_kernels_build_from_one_place():
    assert es_kernel.build_dir() == _build.build_dir()
    for name in ("engine_step", "colibri_scatter"):
        assert _build.source(name).is_file()
