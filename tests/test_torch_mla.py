"""The port's MLA (DeepSeek-V3 multi-head latent attention) and the whole
``deepseek-v3-671b-smoke`` model against the reference's, with the
reference's weights converted (``convert.model_from_jax``).

The smoke config has 2 layers (an MLA layer with a dense FFN, then one
with the MoE FFN of 8 experts, top-2, a shared expert), float32, MLA at
q/k 32 + 16 and v 32 over a latent of 32.  Both packages get the same
numpy-seeded inputs.  The port's prefill runs ``flash_attention`` with v
narrower than q/k (its plain version on the CPU), the reference's
``blocked_attention`` with v padded to q's width; decode is the absorbed
form in latent space on both sides.  Tolerances as the other blocks
(``tests/test_torch_models.py``): 2e-4 per block, 2e-3 for the whole
model's hidden states, caches and logits (other sum orders through two
layers and the final projection); greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed.sharding import Policy
from repro.models import attention as JA
from repro.models import build as j_build
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_from_jax, to_torch, unstack_segments
from repro_torch.models import attention as A
from repro_torch.models import build
from repro_torch.models import transformer as TF
from repro_torch.serving import Request, ServeEngine
from jax_cache import release_compiled  # noqa: F401

NAME = "deepseek-v3-671b-smoke"
POL = Policy()
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(port cfg, reference cfg, reference model, reference params, port
    model on the same weights)."""
    jcfg = j_get_config(NAME)
    jm = j_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(NAME)
    return cfg, jcfg, jm, params, model_from_jax(cfg, _np(params), "cpu")


def _layer(pair, i):
    cfg, _, _, params, model = pair
    ref = unstack_segments(cfg, _np(params["segments"]))[i]
    return jax.tree.map(jnp.asarray, ref), model.blocks[i].params()


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_model_from_jax_carries_the_mla_weights(pair):
    """Every leaf, the per-head 3-D up-projections included, lands in
    the port's layer with the reference's values."""
    cfg, jcfg, _, params, model = pair
    m = cfg.mla
    assert [b.sig for b in model.blocks] == [("attn", "dense"),
                                             ("attn", "moe")]
    n_ref = sum(np.size(a) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    for i in range(cfg.num_layers):
        ref = unstack_segments(cfg, _np(params["segments"]))[i]["attn"]
        got = model.blocks[i].params()["attn"]
        assert set(got) == set(ref)
        assert tuple(got["w_uk"].shape) == (cfg.num_heads, m.qk_nope_head_dim,
                                            m.kv_lora_rank)
        assert tuple(got["w_uv"].shape) == (cfg.num_heads, m.kv_lora_rank,
                                            m.v_head_dim)
        for k in ("w_uk", "w_uv", "w_dq", "w_kr", "wo"):
            np.testing.assert_array_equal(got[k].numpy(), ref[k])
        np.testing.assert_array_equal(got["q_norm"]["scale"].numpy(),
                                      ref["q_norm"]["scale"])


@pytest.mark.parametrize("s", [24, 70])
def test_mla_apply_matches(pair, s):
    cfg, jcfg = pair[0], pair[1]
    jp, p = _layer(pair, 0)
    x = _rand((2, s, cfg.d_model), s)
    pos = np.arange(s)
    want, (wc, wr) = JA.mla_apply(jcfg, jp["attn"], jnp.asarray(x),
                                  jnp.asarray(pos))
    got, (gc, gr) = A.mla_apply(cfg, p["attn"], torch.from_numpy(x),
                                torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **BLOCK_TOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **BLOCK_TOL)


def test_mla_decode_matches(pair):
    """One absorbed decode step against a seeded latent cache, three
    sequences at three positions: the output and the cache written in
    place at each position."""
    cfg, jcfg = pair[0], pair[1]
    jp, p = _layer(pair, 1)
    m = cfg.mla
    x = _rand((3, 1, cfg.d_model), 5)
    cache = {"c_kv": _rand((3, 32, m.kv_lora_rank), 6),
             "k_rope": _rand((3, 32, m.qk_rope_head_dim), 7)}
    pos = np.array([0, 9, 31], np.int32)
    want, wc = JA.mla_decode(jcfg, jp["attn"], jnp.asarray(x),
                             jax.tree.map(jnp.asarray, cache),
                             jnp.asarray(pos))
    tc = to_torch(cache, "cpu")
    got, gc = A.mla_decode(cfg, p["attn"], torch.from_numpy(x), tc,
                           torch.from_numpy(pos))
    assert gc["c_kv"] is tc["c_kv"] and gc["k_rope"] is tc["k_rope"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                   **BLOCK_TOL)


def test_mla_decode_bf16_is_near_the_reference(pair):
    """bf16 weights, cache and activations through the port's absorbed
    decode, against the reference's decode in float32 on the same
    bf16-rounded values (this host's XLA has no bf16 x bf16 -> f32 dot
    for the reference's own bf16 path): the port's roundings (q_lat and P
    to the cache's dtype, the latent context to the weights', the output
    to bf16) keep it within 3e-2 of the unrounded sums."""
    cfg, jcfg = pair[0], pair[1]
    jp, p = _layer(pair, 1)
    m = cfg.mla

    def bf16(a):
        return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)

    pb = jax.tree.map(bf16, _np(jp["attn"]))
    x = bf16(_rand((2, 1, cfg.d_model), 8))
    cache = {"c_kv": bf16(_rand((2, 16, m.kv_lora_rank), 9)),
             "k_rope": bf16(_rand((2, 16, m.qk_rope_head_dim), 10))}
    pos = np.array([4, 15], np.int32)
    as_f32 = lambda t: jnp.asarray(t.float().numpy())   # noqa: E731
    want, _ = JA.mla_decode(jcfg, jax.tree.map(as_f32, pb), as_f32(x),
                            jax.tree.map(as_f32, cache), jnp.asarray(pos))
    got, _ = A.mla_decode(cfg, pb, x, cache, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=3e-2, atol=3e-2)


def test_prefill_and_decode_match_the_reference(pair):
    cfg, _, jm, params, model = pair
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    cache_len = 28
    jh, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len, POL))(
        params, {"tokens": jnp.asarray(toks)})
    th, tc = model.prefill(torch.from_numpy(toks), cache_len)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    for want, got in zip(unstack_segments(cfg, _np(jc)), tc):
        assert set(want["attn"]) == set(got["attn"]) == {"c_kv", "k_rope"}
        for k in want["attn"]:
            np.testing.assert_allclose(got["attn"][k].numpy(),
                                       want["attn"][k], **MODEL_TOL)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, POL))
    tok = toks[:, -1:]
    for i in range(4):
        pos = np.full((2,), 20 + i, np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_served_tokens_equal_the_reference_engine(pair):
    """Prefill and greedy decode through both engines: three prompts of
    5, 9 and 14 tokens (right-padded into one grid), 6 new each."""
    cfg, jcfg, _, params, model = pair
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (5, 9, 14)]
    outs = []
    for eng, req in ((JServeEngine(jcfg, params, batch_size=3, cache_len=32),
                      JRequest),
                     (ServeEngine(cfg, model, batch_size=3, cache_len=32,
                                  device="cpu"), Request)):
        reqs = [req(prompt=p, max_new_tokens=6, id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        assert eng.run_once() == 3
        outs.append([r.result for r in reqs])
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_seeded_init_draws_the_mla_leaves():
    """``init`` draws every MLA leaf in place with the reference's
    scales: the per-head up-projections at ``kv_lora_rank ** -0.5``."""
    cfg = get_config(NAME)
    a = build(cfg, device="cpu").init(5).params()["layers"][0]["attn"]
    b = build(cfg, device="cpu").init(5).params()["layers"][0]["attn"]
    for k in ("w_uk", "w_uv", "w_dq", "wo"):
        assert torch.equal(a[k], b[k])
    std = float(a["w_uk"].std())
    assert abs(std - cfg.mla.kv_lora_rank ** -0.5) < 0.02
    assert torch.equal(a["kv_norm"]["scale"],
                       torch.ones(cfg.mla.kv_lora_rank))


def test_mla_training_is_refused_naming_a9_8e():
    cfg = get_config(NAME)
    with pytest.raises(NotImplementedError, match="A9.8e"):
        TF.check_trainable(cfg)
    dense = dataclasses.replace(cfg, moe=None, name="mla-dense")
    with pytest.raises(NotImplementedError, match="A9.8e"):
        build(dense, device="cpu").train_mode()
