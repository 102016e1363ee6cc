"""The port's RWKV-6 blocks and whole model against the reference's, on
``rwkv6-1.6b-smoke`` (2 ``rwkv`` layers with their ``rwkv_cm``
channel-mix, float32) with the reference's weights converted
(``convert.model_from_jax``).

Both packages get the same numpy-seeded inputs.  The port's prefill runs
the ``rwkv6_wkv`` op (its plain version on the CPU); the reference's runs
its exact sequential scan.  Tolerances: 2e-4 (rtol and atol) per block,
2e-3 for the whole model's hidden states, caches and logits — the two
sum in different orders, and the differences grow through the layers and
the final projection.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec
from repro.distributed.sharding import Policy
from repro.models import build as j_build
from repro.models import layers as JL
from repro.models import make_batch
from repro.models import rwkv6 as JRW
from repro_torch.configs import get_config
from repro_torch.convert import model_from_jax, to_torch, unstack_segments
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as RW

NAME = "rwkv6-1.6b-smoke"
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
    """Layer ``i``'s weights: (reference tree, port tree)."""
    cfg, _, _, params, model = pair
    ref = unstack_segments(cfg, _np(params["segments"]))[i]
    return jax.tree.map(jnp.asarray, ref), model.blocks[i].params()


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_converted_model_holds_the_reference_weights(pair):
    cfg, jcfg, _, params, model = pair
    assert [b.sig for b in model.blocks] == [("rwkv", "rwkv_cm")] * 2
    assert set(model.blocks[0].params()) == {"norm1", "norm2", "rwkv", "cm"}
    n_ref = sum(np.size(a) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    ref = unstack_segments(cfg, _np(params["segments"]))[1]
    got = model.blocks[1].params()
    for part in ("rwkv", "cm"):
        for k, v in ref[part].items():
            np.testing.assert_array_equal(got[part][k].numpy(), v)


def test_groupnorm_matches():
    x = _rand((2, 5, 128), 1, scale=2.0) + 0.3
    scale, bias = _rand((128,), 2), _rand((128,), 3)
    want = JL.groupnorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                        num_groups=4)
    got = L.groupnorm(torch.from_numpy(x), torch.from_numpy(scale),
                      torch.from_numpy(bias), num_groups=4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    half = L.groupnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                       torch.from_numpy(bias), num_groups=4)
    assert half.dtype == torch.bfloat16


def test_time_mix_apply_and_decode_match(pair):
    cfg, jcfg = pair[0], pair[1]
    jp, p = _layer(pair, 0)
    d, hd = cfg.d_model, cfg.recurrent.head_dim
    x = _rand((2, 24, d), 4)
    shift = _rand((2, d), 5)
    zeros = np.zeros((2, d // hd, hd, hd), np.float32)
    want = JRW.time_mix_apply(jcfg, jp["rwkv"], jnp.asarray(x),
                              jnp.asarray(shift), jnp.asarray(zeros))
    got = RW.time_mix_apply(cfg, p["rwkv"], torch.from_numpy(x),
                            torch.from_numpy(shift))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL)
    wkv = _rand((2, d // hd, hd, hd), 6)
    x1 = x[:, :1]
    want = JRW.time_mix_decode(jcfg, jp["rwkv"], jnp.asarray(x1),
                               jnp.asarray(shift), jnp.asarray(wkv))
    got = RW.time_mix_decode(cfg, p["rwkv"], torch.from_numpy(x1),
                             torch.from_numpy(shift), torch.from_numpy(wkv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL)


def test_channel_mix_apply_and_decode_match(pair):
    cfg = pair[0]
    jp, p = _layer(pair, 1)
    x = _rand((2, 24, cfg.d_model), 7)
    shift = _rand((2, cfg.d_model), 8)
    for j_fn, fn, xs in ((JRW.channel_mix_apply, RW.channel_mix_apply, x),
                         (JRW.channel_mix_decode, RW.channel_mix_decode,
                          x[:, :1])):
        want = j_fn(jp["cm"], jnp.asarray(xs), jnp.asarray(shift))
        got = fn(p["cm"], torch.from_numpy(xs), torch.from_numpy(shift))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL)


def test_prefill_and_decode_match_the_reference(pair):
    """Hidden states, the decode cache (the reference's unread
    ``cm_shift`` key aside) and 4 decode steps' logits."""
    cfg, _, jm, params, model = pair
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jh, jc = jax.jit(lambda p, b: jm.prefill(p, b, 32, POL))(
        params, {"tokens": jnp.asarray(toks)})
    th, tc = model.prefill(torch.from_numpy(toks), 32)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    ref_cache = unstack_segments(cfg, _np(jc))
    assert len(ref_cache) == len(tc) == cfg.num_layers
    for want, got in zip(ref_cache, tc):
        assert set(got) == {"rwkv"}
        assert set(got["rwkv"]) == set(want["rwkv"]) == {"shift_tm",
                                                         "shift_cm", "wkv"}
        for k, v in want["rwkv"].items():
            assert got["rwkv"][k].dtype == torch.float32
            np.testing.assert_allclose(got["rwkv"][k].numpy(), v,
                                       **MODEL_TOL)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, POL))
    tok = toks[:, -1:]
    for i in range(4):
        pos = np.full((2,), 24 + i, np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        assert tl.dtype == torch.float32
        assert tuple(tl.shape) == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_stepwise_decode_matches_the_full_forward(pair):
    """Prefill of a prompt, then decode teacher-forced on the rest of the
    sequence: each step's logits equal the reference's full-sequence
    forward at that position."""
    cfg, jcfg, jm, params, model = pair
    s_total, s_prompt = 20, 6
    batch = make_batch(jcfg, ShapeSpec("t", s_total, 2, "train"),
                       jax.random.PRNGKey(1))
    full = np.asarray(jax.jit(lambda p, b: jm.logits(p, b, POL))(params,
                                                                 batch))
    toks = np.array(batch["tokens"], np.int32)
    hidden, cache = model.prefill(torch.from_numpy(toks[:, :s_prompt]),
                                  s_total)
    np.testing.assert_allclose(model.logits(hidden).numpy(),
                               full[:, :s_prompt], **MODEL_TOL)
    for t in range(s_prompt, s_total):
        pos = np.full((2,), t, np.int32)
        lg, cache = model.decode_step(cache,
                                      torch.from_numpy(toks[:, t: t + 1]),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t], **MODEL_TOL)


def test_bfloat16_reference_tree_keeps_w0_and_u_in_float32():
    """The reference keeps ``w0`` and ``u`` in float32 in a bf16 model;
    ``load_params`` casts each leaf to the dtype the port allocated, so
    the port must allocate those two in float32 too."""
    jcfg = dataclasses.replace(j_get_config(NAME), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(NAME), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = j_build(jcfg).init(jax.random.PRNGKey(0))
    model = model_from_jax(cfg, _np(params), "cpu")
    ref = unstack_segments(cfg, _np(params["segments"]))
    for ref_layer, block in zip(ref, model.blocks):
        tm = block.params()["rwkv"]
        for k in ("w0", "u"):
            assert tm[k].dtype == torch.float32
            np.testing.assert_array_equal(tm[k].numpy(), ref_layer["rwkv"][k])
        assert tm["w_r"].dtype == torch.bfloat16
        assert block.params()["cm"]["w_k"].dtype == torch.bfloat16
    seeded = build(cfg, device="cpu").init(0).blocks[0].params()["rwkv"]
    assert seeded["w0"].dtype == seeded["u"].dtype == torch.float32
    assert -7.0 < float(seeded["w0"].mean()) < -3.0
    toks = torch.from_numpy(np.arange(8, dtype=np.int32)[None])
    hidden, cache = model.prefill(toks, 12)
    assert hidden.dtype == torch.bfloat16 and bool(torch.isfinite(
        hidden.float()).all())
    assert all(v.dtype == torch.float32 for c in cache
               for v in c["rwkv"].values())


def test_rwkv_state_init_is_float32_zeros():
    cfg = get_config(NAME)
    st = RW.state_init(cfg, 3, "cpu")
    hd = cfg.recurrent.head_dim
    assert tuple(st["wkv"].shape) == (3, cfg.d_model // hd, hd, hd)
    want = to_torch(_np(JRW.state_init(j_get_config(NAME), 3)), "cpu")
    assert st.keys() == want.keys()
    for k in st:
        assert st[k].dtype == torch.float32 and torch.equal(st[k], want[k])
