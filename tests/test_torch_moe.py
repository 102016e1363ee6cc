"""The port's MoE layer and whole MoE model against the reference's, on
``kimi-k2-1t-a32b-smoke`` (a dense layer, then an MoE layer of 8 experts,
top-2, one shared expert; float32) with the reference's weights converted
(``convert.model_from_jax``).

Both packages get the same numpy-seeded inputs.  The port's experts run
the ``grouped_matmul`` op (its plain version on the CPU); the
reference's run three einsums.  Router picks and every integer of the
dispatch must be equal; gates, the aux loss and the layer's output agree
to 2e-4 (rtol and atol, as the other blocks), the whole model's hidden
states, caches and logits to 2e-3 (the sums run in other orders through
two layers and the final projection).  A capacity factor of 0.5 makes
the experts drop tokens, so the FIFO drop order is exercised.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import dispatch as JD
from repro.distributed.sharding import Policy
from repro.models import attention as JA
from repro.models import build as j_build
from repro.models import moe as JMoE
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_from_jax, unstack_segments
from repro_torch.core import dispatch as D
from repro_torch.models import attention as A
from repro_torch.models import build
from repro_torch.models import moe as MoE
from repro_torch.serving import Request, ServeEngine
from jax_cache import release_compiled  # noqa: F401

NAME = "kimi-k2-1t-a32b-smoke"
POL = Policy()
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
#: the config's own capacity factor, and one that drops tokens
CAPACITY = (1.25, 0.5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(cf):
    """(port cfg, reference cfg) with capacity factor ``cf``."""
    def with_cf(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf))
    return with_cf(get_config(NAME)), with_cf(j_get_config(NAME))


@pytest.fixture(scope="module")
def weights():
    """The reference's params and the port's model on the same weights."""
    jcfg = j_get_config(NAME)
    params = j_build(jcfg).init(jax.random.PRNGKey(0))
    return params, model_from_jax(get_config(NAME), _np(params), "cpu")


def _moe_layer(weights):
    """Layer 1's weights: (reference tree, port tree)."""
    params, model = weights
    ref = unstack_segments(get_config(NAME), _np(params["segments"]))[1]
    return jax.tree.map(jnp.asarray, ref), model.blocks[1].params()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_converted_model_has_a_dense_and_an_moe_layer(weights):
    params, model = weights
    assert [b.sig for b in model.blocks] == [("attn", "dense"),
                                              ("attn", "moe")]
    p = model.blocks[1].params()
    assert set(p) == {"norm1", "norm2", "attn", "moe", "shared"}
    assert p["moe"]["router"].dtype == torch.float32
    n_ref = sum(np.size(a) for a in jax.tree.leaves(params))
    assert sum(t.numel() for t in model.parameters()) == n_ref
    jp, _ = _moe_layer(weights)
    for k in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(p["moe"][k].numpy(),
                                      np.asarray(jp["moe"][k]))


def test_route_matches_the_reference(weights):
    cfg, jcfg = _cfgs(1.25)
    jp, p = _moe_layer(weights)
    x = _rand((64, cfg.d_model), 1)
    want_ids, want_gates, want_aux = JMoE._route(jcfg, jp["moe"]["router"],
                                                 jnp.asarray(x))
    ids, gates, aux = MoE._route(cfg, p["moe"]["router"], torch.from_numpy(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates),
                               **BLOCK_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **BLOCK_TOL)


@pytest.mark.parametrize("t", [1, 8, 48, 2048])
@pytest.mark.parametrize("cf", CAPACITY)
def test_capacity_matches_the_reference(cf, t):
    cfg, jcfg = _cfgs(cf)
    assert MoE.capacity_for(t, cfg) == JMoE.capacity_for(t, jcfg)


@pytest.mark.parametrize("cf", CAPACITY)
def test_moe_apply_matches_the_reference(weights, cf):
    """The layer's output and aux loss, and its dispatch table (from the
    same router picks) equal to the reference's; at capacity factor 0.5
    tokens are dropped, the latest in each expert's queue first."""
    cfg, jcfg = _cfgs(cf)
    jp, p = _moe_layer(weights)
    x = _rand((2, 24, cfg.d_model), 2)
    want, want_aux = JMoE.moe_apply(jcfg, jp["moe"], jnp.asarray(x), POL)
    got, aux = MoE.moe_apply(cfg, p["moe"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **BLOCK_TOL)
    ids, _, _ = MoE._route(cfg, p["moe"]["router"],
                           torch.from_numpy(x.reshape(48, -1)))
    keys = ids.reshape(-1).int()
    cap = MoE.capacity_for(48, cfg)
    src, valid, d = D.dispatch_indices(keys, cfg.moe.num_experts, cap)
    jsrc, jvalid, jd = JD.dispatch_indices(jnp.asarray(keys.numpy()),
                                           cfg.moe.num_experts, cap)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(d.keep.numpy(), np.asarray(jd.keep))
    dropped = int((~d.keep).sum())
    assert dropped == int(torch.clamp(d.counts - cap, min=0).sum())
    assert dropped > 0 or cf > 1


def test_gqa_apply_at_head_dim_112_matches():
    """kimi-k2-1t-a32b's head dim (112, not a multiple of 32) through
    the prefill attention's plain path."""
    cfg = dataclasses.replace(get_config(NAME), head_dim=112)
    jcfg = dataclasses.replace(j_get_config(NAME), head_dim=112)
    jp = JA.gqa_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in _np(jp).items()}
    assert p["wq"].shape == (cfg.d_model, cfg.num_heads * 112)
    x = _rand((2, 40, cfg.d_model), 4, 0.5)
    pos = np.arange(40)
    want, (wk, wv) = JA.gqa_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                  kv_out=True)
    got, (gk, gv) = A.gqa_apply(cfg, p, torch.from_numpy(x),
                                torch.from_numpy(pos), kv_out=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **BLOCK_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **BLOCK_TOL)


@pytest.mark.parametrize("cf", CAPACITY)
def test_prefill_and_decode_match_the_reference(weights, cf):
    params = weights[0]
    cfg, jcfg = _cfgs(cf)
    model = model_from_jax(cfg, _np(params), "cpu")
    jm = j_build(jcfg)
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, 16)).astype(np.int32)
    cache_len = 24
    jh, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len, POL))(
        params, {"tokens": jnp.asarray(toks)})
    th, tc = model.prefill(torch.from_numpy(toks), cache_len)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    for want, got in zip(unstack_segments(cfg, _np(jc)), tc):
        for k in want["attn"]:
            np.testing.assert_allclose(got["attn"][k].numpy(),
                                       want["attn"][k], **MODEL_TOL)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, POL))
    tok = toks[:, -1:]
    for i in range(4):
        pos = np.full((3,), 16 + i, np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        assert tuple(tl.shape) == (3, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_served_tokens_equal_the_reference_engine_with_drops(weights):
    """Greedy tokens through both engines at capacity factor 0.5: three
    12-token prompts route 72 picks into 8 experts of 8 slots, so the
    prefill drops tokens."""
    params = weights[0]
    cfg, jcfg = _cfgs(0.5)
    model = model_from_jax(cfg, _np(params), "cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=(12,)).astype(np.int32)
               for _ in range(3)]
    outs = []
    for eng, req in ((JServeEngine(jcfg, params, batch_size=3, cache_len=32),
                      JRequest),
                     (ServeEngine(cfg, model, batch_size=3, cache_len=32,
                                  device="cpu"), Request)):
        reqs = [req(prompt=p, max_new_tokens=4, id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        assert eng.run_once() == 3
        outs.append([r.result for r in reqs])
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_bf16_model_keeps_a_float32_router():
    """The router is float32 in a bf16 model, as in the reference, and
    converting the reference's bf16 tree keeps its values."""
    cfg = dataclasses.replace(get_config(NAME), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jcfg = dataclasses.replace(j_get_config(NAME), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    params = j_build(jcfg).init(jax.random.PRNGKey(1))
    model = model_from_jax(cfg, _np(params), "cpu")
    p = model.blocks[1].params()["moe"]
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == torch.bfloat16
    jr = unstack_segments(cfg, _np(params["segments"]))[1]["moe"]["router"]
    assert jr.dtype == np.float32
    np.testing.assert_array_equal(p["router"].numpy(), jr)
    toks = torch.from_numpy(np.arange(10, dtype=np.int32)[None])
    hidden, _ = model.prefill(toks, 16)
    assert hidden.dtype == torch.bfloat16
    assert bool(torch.isfinite(hidden.float()).all())


def test_init_draws_in_place_and_is_reproducible():
    """``Model.init`` draws into the tensors ``build`` allocated (no
    parameter's storage changes) and a seed gives the same weights."""
    cfg = get_config(NAME)
    model = build(cfg, device="cpu")
    ptrs = [t.data_ptr() for t in model.parameters()]
    model.init(5)
    assert [t.data_ptr() for t in model.parameters()] == ptrs
    again = build(cfg, device="cpu").init(5)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    other = build(cfg, device="cpu").init(6)
    moe = model.blocks[1].params()["moe"]
    assert not torch.equal(moe["w_up"], other.blocks[1].params()["moe"]["w_up"])
    # each expert's stack is drawn at its own scale: std d^-0.5, f^-0.5
    assert abs(float(moe["w_gate"].std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(moe["w_down"].std())
               * cfg.moe.d_ff_expert ** 0.5 - 1) < 0.05
    assert torch.equal(model.blocks[1].params()["norm1"]["scale"],
                       torch.ones(cfg.d_model))


def test_init_draws_a_large_leaf_in_chunks(monkeypatch):
    """A leaf larger than ``DRAW_CHUNK`` is drawn a few leading rows at
    a time (an expert stack, expert by expert): the weights still come
    out whole, seeded and at their scale."""
    from repro_torch.models import layers as L
    cfg = get_config(NAME)
    whole = build(cfg, device="cpu").init(7)
    monkeypatch.setattr(L, "DRAW_CHUNK", 64 * 128)
    chunked = build(cfg, device="cpu").init(7)
    w = chunked.blocks[1].params()["moe"]["w_gate"]      # (8, 128, 64)
    assert bool(torch.isfinite(w).all())
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    again = build(cfg, device="cpu").init(7)
    assert torch.equal(w, again.blocks[1].params()["moe"]["w_gate"])
    assert torch.equal(whole.params()["final_norm"]["scale"],
                       chunked.params()["final_norm"]["scale"])
