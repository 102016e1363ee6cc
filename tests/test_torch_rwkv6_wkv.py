"""The port's rwkv6_wkv op against the reference's WKV.

On the CPU, ``repro_torch.kernels.rwkv6_wkv`` takes its plain version
(the exact recurrence walked in order).  It is held to the reference's
oracle ``wkv_ref`` and its model's ``_wkv_scan`` (both exact, 1e-4: the
sums run in another order), and to the Pallas ``wkv_chunked`` in
interpret mode, as ``tests/test_kernels.py`` runs it, at that file's
chunk of 32 and tolerance of 2e-3.  Inputs are drawn with numpy as the
reference tests draw theirs (r, k ~ N(0, 0.25), v ~ N(0, 1), u ~ N(0,
0.01), w = exp(-exp(x))), with x ~ N(-1.5, 1) as in those tests and the
strong decays N(0, 1) and N(1, 1).

The Pallas kernel clamps its factored in-chunk decay at +-30 in log
space, so at its default chunk of 64 it is wrong once a chunk's decay
passes that; one case pins that fault of the reference, which the port's
exact recurrence does not share.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import wkv_chunked as j_chunked
from repro.kernels.rwkv6_wkv.ref import wkv_ref as j_ref
from repro.models.rwkv6 import _wkv_scan as j_scan
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.rwkv6_wkv import wkv, wkv_chunked, wkv_ref
from repro_torch.kernels.rwkv6_wkv.kernel import wkv_cuda
from jax_cache import release_compiled  # noqa: F401

EXACT_TOL = dict(rtol=1e-4, atol=1e-4)
CHUNKED_TOL = dict(rtol=2e-3, atol=2e-3)
#: means of x in w = exp(-exp(x)), x ~ N(mean, 1)
DECAYS = (-1.5, 0.0, 1.0)
#: (B, T, H, hd): the reference tests' (BH, T, hd) shapes with BH as
#: (B, H), and a 1 000-step one
SHAPES = ((2, 64, 1, 32), (2, 130, 2, 64), (1, 32, 1, 16), (2, 1000, 2, 32))


def _inputs(b, t, h, hd, decay, seed):
    """r, k, v, w ``(B, T, H, hd)`` and u ``(H, hd)``, float32."""
    rng = np.random.default_rng(seed)
    shape = (b, t, h, hd)
    r = rng.standard_normal(shape) * 0.5
    k = rng.standard_normal(shape) * 0.5
    v = rng.standard_normal(shape)
    w = np.exp(-np.exp(rng.standard_normal(shape) + decay))
    u = rng.standard_normal((h, hd)) * 0.1
    return [x.astype(np.float32) for x in (r, k, v, w, u)]


def _rows(x):
    """``(B, T, H, hd)`` -> the reference op's ``(B*H, T, hd)``."""
    b, t, h, hd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, hd))


def _bh_inputs(bh, t, hd, decay, seed):
    """The reference op's layout: r, k, v, w ``(BH, T, hd)``, u ``(BH,
    hd)``."""
    r, k, v, w, u = _inputs(1, t, bh, hd, decay, seed)
    return [_rows(x) for x in (r, k, v, w)] + [u]


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES)
def test_wkv_matches_the_exact_recurrence(shape, decay):
    """``out`` against ``wkv_ref`` (the reference's oracle, in its
    (BH, T, hd) layout), ``out`` and the final state against the
    reference model's ``_wkv_scan``."""
    b, t, h, hd = shape
    r, k, v, w, u = _inputs(*shape, decay, seed=[t, h, hd])
    out, state = wkv(*(torch.from_numpy(x) for x in (r, k, v, w, u)))
    assert out.dtype == state.dtype == torch.float32
    assert tuple(out.shape) == shape and tuple(state.shape) == (b, h, hd, hd)
    want_o, want_s = j_scan(*(jnp.asarray(x) for x in (r, k, v, w, u)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), **EXACT_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s),
                               **EXACT_TOL)
    want_rows = j_ref(*(jnp.asarray(_rows(x)) for x in (r, k, v, w)),
                      jnp.asarray(np.tile(u, (b, 1))))
    np.testing.assert_allclose(_rows(out.numpy()), np.asarray(want_rows),
                               **EXACT_TOL)


@pytest.mark.parametrize("bh,t,hd", [(2, 64, 32), (4, 130, 64), (1, 32, 16)])
def test_wkv_chunked_matches_the_pallas_kernel(bh, t, hd):
    """At ``tests/test_kernels.py``'s chunk of 32 and decays N(-1.5, 1),
    where the Pallas kernel is right."""
    ins = _bh_inputs(bh, t, hd, -1.5, seed=[bh, t, hd])
    want = np.asarray(j_chunked(*(jnp.asarray(x) for x in ins), block_c=32))
    got = wkv_chunked(*(torch.from_numpy(x) for x in ins))
    assert got.dtype == torch.float32 and tuple(got.shape) == (bh, t, hd)
    np.testing.assert_allclose(got.numpy(), want, **CHUNKED_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_ref(*(jnp.asarray(x) for x in ins))),
        **EXACT_TOL)


def test_the_port_avoids_the_pallas_clamp_fault():
    """At the Pallas kernel's default chunk of 64 with the reference
    tests' decays N(-1.5, 1), its +-30 clamp makes it wrong; the port
    still equals the exact recurrence."""
    ins = _bh_inputs(2, 128, 32, -1.5, seed=7)
    exact = np.asarray(j_ref(*(jnp.asarray(x) for x in ins)))
    pallas = np.asarray(j_chunked(*(jnp.asarray(x) for x in ins),
                                  block_c=64))
    got = wkv_chunked(*(torch.from_numpy(x) for x in ins)).numpy()
    np.testing.assert_allclose(got, exact, **EXACT_TOL)
    assert np.abs(pallas - exact).max() > 0.1


def test_cpu_path_launches_no_kernel():
    ins = [torch.from_numpy(x) for x in _inputs(1, 8, 2, 16, -1.5, 0)]
    before = LAUNCHES["rwkv6_wkv"]
    out, state = wkv(*ins)
    want_o, want_s = wkv_ref(*ins)
    assert torch.equal(out, want_o) and torch.equal(state, want_s)
    assert LAUNCHES["rwkv6_wkv"] == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper checks its inputs before it builds or launches
    anything; CPU tensors go to the plain version, never to it."""
    ins = [torch.from_numpy(x) for x in _inputs(1, 8, 2, 16, -1.5, 0)]
    with pytest.raises(ValueError, match="CUDA"):
        wkv_cuda(*ins)
    assert _build.source("rwkv6_wkv").is_file()
