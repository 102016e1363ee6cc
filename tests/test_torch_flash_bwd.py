"""The gradient of the port's flash-attention op against the reference.

The reference differentiates its plain ``blocked_attention``
(``repro/models/attention.py``) with XLA, its KV heads repeated to the
query heads by ``_expand_kv`` (so ``jax.vjp`` sums the group into each KV
head).  On the CPU the port's op takes ``FlashAttention`` when a gradient
is wanted: ``flash_attention_fwd_lse_ref`` forward and
``flash_attention_bwd_ref`` backward, the plain versions of the CUDA
kernels.  Both get the same numpy-seeded inputs and output gradient.
The windowed op (the ``local`` layers' band) is held to the VJP of the
reference's ``sliding_window_attention`` past the smoke config's window
of 64.  Tolerance: rtol 1e-5, atol 2e-5 in float32 (the reference's
online softmax and the port's direct one sum in different orders; the
gradients are O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import (_expand_kv, blocked_attention,
                                    sliding_window_attention)
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_fwd_lse_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.kernel import (
    BWD_HEAD_DIMS, flash_attention_bwd_cuda, flash_attention_fwd_lse_cuda)
from jax_cache import release_compiled  # noqa: F401

#: (b, sq, skv, h, kv, hd, causal): GQA groups of 1, 2, 3 and 4, ragged
#: lengths (not multiples of the reference's blocks or the kernels'
#: tiles), causal and not; stablelm-3b's hd 80 causal and phi-3-vision's
#: hd 96 non-causal at Sq != Skv (whisper's cross-attention's form)
CASES = [(2, 37, 37, 4, 2, 32, True), (1, 50, 50, 6, 2, 16, True),
         (2, 33, 57, 4, 1, 32, False), (1, 40, 40, 3, 3, 8, False),
         (1, 29, 29, 4, 4, 64, True), (1, 30, 30, 4, 2, 80, True),
         (1, 25, 47, 2, 2, 96, False)]
RTOL, ATOL = 1e-5, 2e-5


def _inputs(b, sq, skv, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd),
                           (b, sq, h, hd)))


def _reference_vjp(q, k, v, do, causal, window=0):
    h = q.shape[2]

    def f(q_, k_, v_):
        ke, ve = _expand_kv(k_, h), _expand_kv(v_, h)
        if window:
            return sliding_window_attention(q_, ke, ve, window=window,
                                            q_sub=16)
        return blocked_attention(q_, ke, ve, causal=causal, q_block=16,
                                 kv_block=16)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_autograd_op_matches_the_reference_vjp(case):
    *dims, causal = case
    q, k, v, do = _inputs(*dims, seed=list(dims))
    want_out, want = _reference_vjp(q, k, v, do, causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=RTOL,
                               atol=ATOL)
    for name, got, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                            want):
        np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("window,s", [(64, 150), (7, 40)],
                         ids=["smoke_window_s150", "w7_s40"])
def test_windowed_gradient_matches_sliding_window_attention(window, s):
    """The band (key j visible to query i iff j <= i and i - j < window)
    through ``FlashAttention`` against the VJP of the reference's
    ``sliding_window_attention``: the smoke config's window of 64 at a
    ragged 150 tokens, and a window of 7 (not a divisor of 40), GQA 4 on
    2."""
    q, k, v, do = _inputs(1, s, s, 4, 2, 32, seed=window + s)
    want_out, want = _reference_vjp(q, k, v, do, True, window)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True, window=window)
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=RTOL,
                               atol=ATOL)
    for name, got, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                            want):
        np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "x".join(map(str, c)))
def test_backward_plain_version_matches_the_reference_vjp(case):
    """``flash_attention_bwd_ref`` alone, from the forward's o and lse."""
    *dims, causal = case
    q, k, v, do = _inputs(*dims, seed=1 + sum(dims))
    _, want = _reference_vjp(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_fwd_lse_ref(tq, tk, tv, causal=causal)
    got = flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_is_the_row_logsumexp(causal):
    q, k, v, _ = _inputs(2, 21, 21, 4, 2, 16, seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_attention_fwd_lse_ref(tq, tk, tv, causal=causal)
    assert torch.equal(o, flash_attention_ref(tq, tk, tv, causal=causal))
    ke = np.repeat(k, 2, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  ke.astype(np.float64)) / 4.0
    if causal:
        s = np.where(np.tril(np.ones((21, 21), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", [(1, 7, 7, 4, 2, 4, True),
                                  (2, 5, 9, 2, 1, 4, False)],
                         ids=["causal_gqa", "full_ragged"])
def test_gradcheck_in_float64(case):
    *dims, causal = case
    b, sq, skv, h, kv, hd = dims
    rng = np.random.default_rng(11)
    args = tuple(torch.from_numpy(rng.standard_normal(s)).requires_grad_()
                 for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal), args)


def test_gradcheck_of_the_band_in_float64():
    rng = np.random.default_rng(12)
    args = tuple(torch.from_numpy(rng.standard_normal(s)).requires_grad_()
                 for s in ((1, 9, 4, 4), (1, 9, 2, 4), (1, 9, 2, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, True, 3), args)


def test_serving_takes_the_plain_call():
    """No gradient wanted (grad mode off, or no input requiring one): the
    op's serving path, the same bits as the plain version, no graph."""
    q, k, v, _ = _inputs(1, 12, 12, 4, 2, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.grad_fn is None
    assert torch.equal(out, flash_attention_ref(tq, tk, tv, causal=True))
    with torch.no_grad():
        out = flash_attention(tq.requires_grad_(), tk, tv, causal=True)
    assert out.grad_fn is None


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 2, 32, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_fwd_lse_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(q, k, v, q, do, torch.zeros(1, 2, 8))
    assert BWD_HEAD_DIMS == (32, 64, 80, 96, 112, 128, 256)
    with pytest.raises(ValueError, match="causal band"):
        flash_attention_bwd_ref(q, k, v, q, do, torch.zeros(1, 2, 8),
                                causal=False, window=4)
