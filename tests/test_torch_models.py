"""The port's LM blocks and whole model against the reference's, on
``recurrentgemma-2b-smoke`` (4 ``rglru`` and 2 ``local`` layers, float32)
with the reference's weights converted (``convert.model_from_jax``).

Both packages get the same numpy-seeded inputs.  The port's prefill runs
the ``rglru_scan`` and ``flash_attention`` ops (their plain versions on
the CPU); the reference's runs an associative scan and its blocked or
sliding-window attention.  Tolerances: 2e-4 (rtol and atol) per block,
2e-3 for the whole model's hidden states, caches and logits — the two
sum in different orders, and the differences grow through six layers
and the final projection.
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
from repro.models import attention as JA
from repro.models import build as j_build
from repro.models import make_batch
from repro.models import rglru as JRG
from repro_torch.configs import get_config
from repro_torch.convert import model_from_jax, to_torch, unstack_segments
from repro_torch.models import attention as A
from repro_torch.models import build
from repro_torch.models import rglru as RG
from jax_cache import release_compiled  # noqa: F401

NAME = "recurrentgemma-2b-smoke"
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


def test_model_from_jax_without_a_gpu_raises(pair, monkeypatch):
    """Like ``build``, the converter defaults to the GPU: with none
    visible and no ``device``, it raises instead of building on the CPU."""
    cfg, _, _, params, _ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_from_jax(cfg, _np(params))


def test_to_torch_without_a_gpu_raises(monkeypatch):
    """``to_torch`` defaults to the GPU too: with none visible and no
    ``device``, it raises instead of putting the tensors on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_torch({"w": np.zeros(3, np.float32)})
    got = to_torch({"w": np.zeros(3, np.float32)}, "cpu")["w"]
    assert got.device.type == "cpu"


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
    assert model.blocks[0].sig == ("rglru", "mlp")
    assert [b.sig[0] for b in model.blocks] == list(jcfg.layer_kinds())
    n_ref = sum(np.size(a) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(model.params()["embed"].numpy(),
                                  np.asarray(params["embed"]))


def test_rglru_apply_and_decode_match(pair):
    cfg, jcfg = pair[0], pair[1]
    jp, p = _layer(pair, 0)
    x = _rand((2, 24, cfg.d_model), 1)
    st = {"h": _rand((2, cfg.d_model), 2), "conv": _rand((2, 3, cfg.d_model),
                                                          3)}
    want, wst = JRG.rglru_apply(jcfg, jp["rglru"], jnp.asarray(x),
                                jax.tree.map(jnp.asarray, st))
    got, gst = RG.rglru_apply(cfg, p["rglru"], torch.from_numpy(x),
                              to_torch(st, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                   **BLOCK_TOL)
    x1 = x[:, :1]
    want, wst = JRG.rglru_decode(jcfg, jp["rglru"], jnp.asarray(x1),
                                 jax.tree.map(jnp.asarray, st))
    got, gst = RG.rglru_decode(cfg, p["rglru"], torch.from_numpy(x1),
                               to_torch(st, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                   **BLOCK_TOL)


@pytest.mark.parametrize("window", [0, 64])
def test_gqa_apply_matches(pair, window):
    """``attn`` (blocked causal attention in the reference) and ``local``
    (sliding-window attention; the prompt fits the window)."""
    cfg, jcfg = pair[0], pair[1]
    jp, p = _layer(pair, 2)
    x = _rand((2, 40, cfg.d_model), 4)
    pos = np.arange(40)
    want, (wk, wv) = JA.gqa_apply(jcfg, jp["attn"], jnp.asarray(x),
                                  jnp.asarray(pos), window=window,
                                  kv_out=True)
    got, (gk, gv) = A.gqa_apply(cfg, p["attn"], torch.from_numpy(x),
                                torch.from_numpy(pos), window=window,
                                kv_out=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **BLOCK_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **BLOCK_TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_decode_matches(pair, window):
    """One decode step against a seeded cache: the full cache and the
    ring buffer of a local layer (window 8, positions past it)."""
    cfg, jcfg = pair[0], pair[1]
    jp, p = _layer(pair, 2)
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    s_cache = window or 32
    x = _rand((3, 1, cfg.d_model), 5)
    cache = {"k": _rand((3, s_cache, kv, hd), 6),
             "v": _rand((3, s_cache, kv, hd), 7)}
    pos = np.array([3, 9, 21], np.int32)
    want, wc = JA.gqa_decode(jcfg, jp["attn"], jnp.asarray(x),
                             jax.tree.map(jnp.asarray, cache),
                             jnp.asarray(pos), window=window)
    got, gc = A.gqa_decode(cfg, p["attn"], torch.from_numpy(x),
                           to_torch(cache, "cpu"), torch.from_numpy(pos),
                           window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                   **BLOCK_TOL)


def test_prefill_and_decode_match_the_reference(pair):
    cfg, _, jm, params, model = pair
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    cache_len = 32
    jh, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len, POL))(
        params, {"tokens": jnp.asarray(toks)})
    th, tc = model.prefill(torch.from_numpy(toks), cache_len)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    ref_cache = unstack_segments(cfg, _np(jc))
    assert len(ref_cache) == len(tc) == cfg.num_layers
    for want, got in zip(ref_cache, tc):
        assert want.keys() == got.keys()
        for kind in want:
            for k in want[kind]:
                np.testing.assert_allclose(got[kind][k].numpy(),
                                           want[kind][k], **MODEL_TOL)
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


def test_local_attention_ring_buffer():
    """Sliding-window decode with a ring buffer (window 8, decoding well
    past it) matches the reference's full-sequence local attention, as
    ``tests/test_models.py::test_local_attention_ring_buffer`` holds the
    reference's own decode to it; every step also matches the
    reference's decode step."""
    jcfg = dataclasses.replace(j_get_config(NAME), local_window=8)
    cfg = dataclasses.replace(get_config(NAME), local_window=8)
    jm = j_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = model_from_jax(cfg, _np(params), "cpu")
    s_total, s_prompt = 24, 4
    batch = make_batch(jcfg, ShapeSpec("t", s_total, 2, "train"),
                       jax.random.PRNGKey(1))
    full_logits = jax.jit(lambda p, b: jm.logits(p, b, POL))(params, batch)
    toks = np.array(batch["tokens"], np.int32)
    pre = {"tokens": jnp.asarray(toks[:, :s_prompt])}
    _, jc = jax.jit(lambda p, b: jm.prefill(p, b, s_total, POL))(params, pre)
    _, tc = model.prefill(torch.from_numpy(toks[:, :s_prompt]), s_total)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, POL))
    for t in range(s_prompt, s_total):
        tok = toks[:, t: t + 1]
        pos = np.full((2,), t, np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(tl[:, 0].numpy(),
                               np.asarray(full_logits[:, -1]),
                               rtol=2e-2, atol=2e-2)


def test_local_prompt_longer_than_the_window_is_refused(pair):
    """No longer refused: a prompt past the local layers' window (64
    here) is prefilled through the windowed flash attention, and the
    hidden states, the ring-buffer caches and the next logits equal the
    reference's (its sliding_window_attention)."""
    cfg, _, jm, params, model = pair
    s = cfg.local_window + 37
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, s)).astype(np.int32)
    cache_len = 2 * cfg.local_window
    jh, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len, POL))(
        params, {"tokens": jnp.asarray(toks)})
    th, tc = model.prefill(torch.from_numpy(toks), cache_len)
    assert tuple(th.shape) == (2, s, cfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    for want, got in zip(unstack_segments(cfg, _np(jc)), tc):
        for kind in want:
            for k in want[kind]:
                np.testing.assert_allclose(got[kind][k].numpy(),
                                           want[kind][k], **MODEL_TOL)


def test_seeded_init_is_reproducible():
    cfg = get_config(NAME)
    a = build(cfg, device="cpu").init(3).params()
    b = build(cfg, device="cpu").init(3).params()
    assert torch.equal(a["layers"][2]["attn"]["wq"], b["layers"][2]["attn"]["wq"])
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert a["layers"][0]["rglru"]["lam"].min() >= 2.0


def test_bfloat16_reference_arrays_convert():
    """Full-size configs keep their weights in bfloat16; numpy holds those
    as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not take."""
    vals = jnp.asarray([[-1.5, 0.1], [3.0, 2.0 ** -9]], jnp.bfloat16)
    got = to_torch({"w": np.asarray(vals)}, "cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(vals, np.float32))


def test_load_params_refuses_a_tree_of_another_shape(pair):
    cfg, model = pair[0], pair[4]
    tree = model.params()
    tree["layers"][0]["mlp"]["w_up"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match=r"layers\[0\]\.mlp\.w_up"):
        build(cfg, device="cpu").load_params(tree)
    del tree["layers"][-1]
    with pytest.raises(ValueError, match="entries"):
        build(cfg, device="cpu").load_params(tree)
