"""The recurrence kernels' orders of operations, emulated on the CPU.

``csrc/rwkv6_wkv.cu`` and ``csrc/rglru_scan.cu`` do not walk their
recurrences one step at a time as the plain versions do.  A CUDA kernel
cannot run here, so this file repeats each design's arithmetic in plain
torch and holds it against the JAX package's oracles
(``repro.kernels.rwkv6_wkv.ref.wkv_ref``,
``repro.kernels.rglru_scan.ref.rglru_scan_ref``) on numpy-seeded inputs,
under the card's tolerances (``chip_smoke.RWKV_TOL``/``RGLRU_TOL``):

* WKV: 16-step sub-tiles, each a step of the recurrence in matrix form.
  Inside a sub-tile, A[t, s] (s < t) is taken exactly, as
  ``sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i]`` with a running product
  (no factoring), and its diagonal holds the bonus ``r_t . (u * k_t)``;
  the decays enter only as running products of ``w`` in (0, 1), so no
  factor exceeds 1 (``w`` may underflow to 0).  Then ``out = [r~ | A] @
  [S; V]`` and ``S = diag(P) S + k~^T V``, with ``r~_t = r_t prod_{m<=tau
  <t} w``, ``k~_s = k_s prod_{s<tau<=end} w`` and ``P`` the sub-tile's
  whole product.  The products run as 3xTF32 (each operand split into a
  round-to-nearest 10-bit-mantissa ``hi`` and ``lo = x - hi`` cut to 10
  bits; ``lo hi + hi lo + hi hi``, f32 sums), as the kernel's TF32
  ``wgmma`` products compute them.  One case per decay records that one
  TF32 pass would not hold ``RWKV_TOL``.
* rglru: tiles of 64 steps x 128 lanes.  Each tile's aggregate ``(prod
  a, h at its end from 0)``, the carry into it composed from the earlier
  tiles of its lanes (the longest look-back, over aggregates only back
  to the first tile, and the shortest, the tile before's inclusive
  value), then the tile walked from its carry with one FMA a step.

It says whether the designs fit the tolerances before any card time; it
does not stand in for the card's comparison (``chip_smoke.py``,
``tests/test_torch_gpu.py``).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_scan_ref as j_rglru
from repro.kernels.rwkv6_wkv.ref import wkv_ref as j_wkv

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
#: steps per sub-tile of the WKV design (``kSub`` in rwkv6_wkv.cu)
WKV_SUB = 16
#: steps and lanes per tile of the rglru design (``kSteps``, ``kLanes``)
RGLRU_STEPS, RGLRU_LANES = 64, 128


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to a 10-bit mantissa, to nearest
    with ties away from zero (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """f32 cut to a 10-bit mantissa (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's product: both operands split into ``hi = tf32(x)`` and
    ``lo = x - hi`` cut to tf32, ``(lo hi + hi lo) + hi hi`` (each product
    exact in f32)."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32_cut(a - a_hi), tf32_cut(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: both operands rounded once."""
    return tf32(a) @ tf32(b)


def wkv_sub_tile(r, k, w, u):
    """One sub-tile's operands from its raw r, k, w ``(..., L, hd)`` (padded
    rows: r = k = 0, w = 1) and u ``(..., hd)``: A ``(..., L, L)``, r~,
    k~ and P, in the kernel's order."""
    n = r.shape[-2]
    a = torch.zeros(r.shape[:-1] + (n,))
    kappa = k.clone()                       # k_s prod_{s<tau<t} w_tau
    for t in range(n):
        a[..., t, :t] = (r[..., t, None, :] * kappa[..., :t, :]).sum(-1)
        a[..., t, t] = (r[..., t, :] * u * k[..., t, :]).sum(-1)
        kappa[..., :t, :] = kappa[..., :t, :] * w[..., t, None, :]
    r_t, k_t = torch.empty_like(r), torch.empty_like(k)
    p = torch.ones_like(r[..., 0, :])
    for t in range(n):                      # exclusive prefix products
        r_t[..., t, :] = r[..., t, :] * p
        p = p * w[..., t, :]
    q = torch.ones_like(p)
    for s in reversed(range(n)):            # exclusive suffix products
        k_t[..., s, :] = k[..., s, :] * q
        q = q * w[..., s, :]
    return a, r_t, k_t, p


def wkv_emulation(r, k, v, w, u, mm=mm_3xtf32):
    """The WKV design: r, k, v, w ``(B, T, H, hd)``, u ``(H, hd)`` f32 ->
    (out ``(B, T, H, hd)``, final state ``(B, H, hd, hd)``)."""
    b, t_len, h, hd = r.shape
    r, k, v, w = (x.transpose(1, 2) for x in (r, k, v, w))   # (B, H, T, hd)
    s = torch.zeros((b, h, hd, hd))
    out = torch.empty((b, h, t_len, hd))
    for m in range(0, t_len, WKV_SUB):
        n = min(WKV_SUB, t_len - m)
        pad = WKV_SUB - n

        def tile(x, fill):
            x = x[:, :, m:m + n]
            return torch.cat([x, torch.full((b, h, pad, hd), fill)], 2)
        rs, ks, ws, vs = tile(r, 0.0), tile(k, 0.0), tile(w, 1.0), \
            tile(v, 0.0)
        a, r_t, k_t, p = wkv_sub_tile(rs, ks, ws, u[None, :, :])
        o = mm(torch.cat([r_t, a], -1), torch.cat([s, vs], -2))
        out[:, :, m:m + n] = o[:, :, :n]
        s = p[..., :, None] * s + mm(k_t.transpose(-1, -2), vs)
    return out.transpose(1, 2), s


def _wkv_inputs(b, t, h, hd, decay, seed):
    """r, k, v, w ``(B, T, H, hd)`` and u ``(H, hd)`` float32, drawn as the
    reference tests draw them."""
    rng = np.random.default_rng(seed)
    shape = (b, t, h, hd)
    r = rng.standard_normal(shape) * 0.5
    k = rng.standard_normal(shape) * 0.5
    v = rng.standard_normal(shape)
    w = np.exp(-np.exp(rng.standard_normal(shape) + decay))
    u = rng.standard_normal((h, hd)) * 0.1
    return [x.astype(np.float32) for x in (r, k, v, w, u)]


def _wkv_oracle(r, k, v, w, u):
    """The JAX oracle on ``(B, T, H, hd)`` inputs: (out, final state), the
    state from the same recurrence walked in float64 numpy."""
    b, t, h, hd = r.shape

    def rows(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, hd))
    out = np.asarray(j_wkv(rows(r), rows(k), rows(v), rows(w),
                           jnp.asarray(np.tile(u, (b, 1)))))
    out = out.reshape(b, h, t, hd).transpose(0, 2, 1, 3)
    s = np.zeros((b, h, hd, hd))
    for i in range(t):
        s = w[:, i, :, :, None] * s + k[:, i, :, :, None] * v[:, i, :, None, :]
    return out, s


def _close(got, want, tol) -> bool:
    return np.allclose(got, want, rtol=tol[0], atol=tol[1])


#: (B, T, H, hd): one step, a sub-tile and more, T not a multiple of the
#: sub-tile nor of the 64-step staging chunk (100, 130), and each head dim
WKV_SHAPES = ((1, 1, 2, 64), (2, 17, 1, 32), (1, 100, 2, 64),
              (1, 130, 2, 16), (1, 64, 1, 64))


@pytest.mark.parametrize("decay", CS.RWKV_DECAYS)
@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv_design_matches_the_oracle(shape, decay):
    """The sub-tile form with 3xTF32 products holds RWKV_TOL for out and
    the final state, at every decay of chip_smoke (N(1, 1) underflows
    single steps' w to 0)."""
    ins = _wkv_inputs(*shape, decay, seed=[*shape, int(decay * 10) + 50])
    want_out, want_s = _wkv_oracle(*ins)
    out, s = wkv_emulation(*(torch.from_numpy(x) for x in ins))
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(out.numpy(), want_out, *CS.RWKV_TOL)
    np.testing.assert_allclose(s.numpy(), want_s, *CS.RWKV_TOL)


@pytest.mark.parametrize("decay", CS.RWKV_DECAYS)
def test_wkv_design_never_forms_a_factor_above_one(decay):
    """Every decay factor the design multiplies by, prefix and suffix
    products and the exact in-tile products, lies in [0, 1]."""
    r, k, v, w, u = (torch.from_numpy(x)
                     for x in _wkv_inputs(1, WKV_SUB, 1, 16, decay, seed=3))
    ones = torch.ones((1, WKV_SUB, 16))
    a, r_t, k_t, p = wkv_sub_tile(ones, ones, w[:, :, 0], u)
    for factor in (r_t, k_t, p):
        assert factor.min() >= 0.0 and factor.max() <= 1.0
    lower = torch.tril(torch.ones(WKV_SUB, WKV_SUB), -1).bool()
    assert a[0][lower].min() >= 0.0 and a[0][lower].max() <= 16.0


def _share_of_tolerance(got, want, tol) -> float:
    """The worst |got - want| over what allclose allows, atol + rtol |want|."""
    return float((np.abs(got - want) / (tol[1] + tol[0] * np.abs(want))).max())


@pytest.mark.parametrize("decay", CS.RWKV_DECAYS)
def test_one_tf32_pass_misses_the_wkv_tolerance(decay):
    """Why the kernel splits each operand: at the serve path's head dim,
    T 256, one TF32 pass misses RWKV_TOL at every decay of chip_smoke,
    where 3xTF32 stays under 1 % of it."""
    ins = _wkv_inputs(1, 256, 2, 64, decay, seed=11)
    want_out, _ = _wkv_oracle(*ins)
    t_ins = [torch.from_numpy(x) for x in ins]
    out3, _ = wkv_emulation(*t_ins, mm=mm_3xtf32)
    out1, _ = wkv_emulation(*t_ins, mm=mm_1xtf32)
    assert _share_of_tolerance(out3.numpy(), want_out, CS.RWKV_TOL) < 0.01
    assert _share_of_tolerance(out1.numpy(), want_out, CS.RWKV_TOL) > 1.0


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0])
    assert torch.equal(tf32(x), want)


def rglru_emulation(a, x, h0, lookback: str):
    """The rglru design: a, x ``(T, B, w)``, h0 ``(B, w)`` f32 -> h.  Lane
    tiles of ``RGLRU_LANES`` columns within each batch row; the carry
    into a tile composed from the earlier tiles' aggregates back to the
    first (``lookback="aggregates"``) or from the tile before's
    inclusive value (``"inclusive"``)."""
    def fma(p, q, c):
        return (p.double() * q.double() + c.double()).float()
    t_len = a.shape[0]
    h = torch.empty_like(a)
    incl, aggs = [], []             # each chunk's h at its end, aggregate
    for ci, t0 in enumerate(range(0, t_len, RGLRU_STEPS)):
        ta, tx = a[t0:t0 + RGLRU_STEPS], x[t0:t0 + RGLRU_STEPS]
        agg_a, agg_b = torch.ones_like(h0), torch.zeros_like(h0)
        for i in range(ta.shape[0]):
            agg_a, agg_b = agg_a * ta[i], fma(ta[i], agg_b, tx[i])
        if ci == 0:
            carry = h0.clone()
        elif lookback == "inclusive":
            carry = incl[-1]
        else:
            carry_a, carry_b = torch.ones_like(h0), torch.zeros_like(h0)
            for j in reversed(range(1, ci)):
                carry_a, carry_b = carry_a * aggs[j][0], \
                    fma(carry_a, aggs[j][1], carry_b)
            carry = fma(carry_a, incl[0], carry_b)
        aggs.append((agg_a, agg_b))
        incl.append(fma(agg_a, carry, agg_b))
        hh = carry
        for i in range(ta.shape[0]):
            hh = fma(ta[i], hh, tx[i])
            h[t0 + i] = hh
    return h


def _rglru_inputs(t, b, w, seed):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-(rng.standard_normal((t, b, w)) + 2.0)))
    x = rng.standard_normal((t, b, w)) * 0.3
    h0 = rng.standard_normal((b, w))
    return [v.astype(np.float32) for v in (a, x, h0)]


#: (T, B, w): one step, T not a multiple of the tile (100, 130), widths
#: not a multiple of the lane tile (60, 200) and one that is (256)
RGLRU_SHAPES = ((1, 2, 60), (100, 3, 60), (130, 2, 200), (256, 1, 256),
                (65, 4, 128))


@pytest.mark.parametrize("lookback", ["aggregates", "inclusive"])
@pytest.mark.parametrize("shape", RGLRU_SHAPES)
def test_rglru_design_matches_the_oracle(shape, lookback):
    """The tiled scan with look-back carries, from a nonzero h0, holds
    RGLRU_TOL against the associative-scan oracle."""
    a, x, h0 = _rglru_inputs(*shape, seed=[*shape, len(lookback)])
    want = np.asarray(j_rglru(jnp.asarray(a), jnp.asarray(x),
                              jnp.asarray(h0)))
    got = rglru_emulation(*(torch.from_numpy(v) for v in (a, x, h0)),
                          lookback)
    np.testing.assert_allclose(got.numpy(), want, *CS.RGLRU_TOL)


def test_rglru_design_uses_its_carry():
    """A tile's look-back matters: with the carries zeroed past the first
    tile the result differs, so the cases above exercise it."""
    a, x, h0 = (torch.from_numpy(v) for v in _rglru_inputs(130, 1, 8, 7))
    got = rglru_emulation(a, x, h0, "aggregates")
    cut = rglru_emulation(a[RGLRU_STEPS:], x[RGLRU_STEPS:],
                          torch.zeros_like(h0), "aggregates")
    assert not torch.allclose(got[RGLRU_STEPS:], cut, *CS.RGLRU_TOL)
