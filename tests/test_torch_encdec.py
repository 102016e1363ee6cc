"""The port's encoder-decoder (``repro_torch.models.encdec``) and the whole
``whisper-large-v3-smoke`` model against the reference's
(``repro/models/encdec.py``), with the reference's weights converted
(``convert.model_from_jax``: the stacked ``enc_blocks`` and
``segments[0]["u0"]`` become one dict per layer).

The smoke config: 2 encoder and 2 decoder layers, d 128, 4 heads of 32,
16 frames, float32.  Both packages get the same numpy-seeded inputs.  The
port's attention goes through the ``flash_attention`` op (its plain
version on the CPU): non-causal in the encoder and in the cross-attention
(Sq decoder positions against 16 frames), causal in the decoder's
self-attention; the reference's through ``blocked_attention``.
Tolerances: the sinusoidal table 1e-6; ``cross_attn_apply`` rtol 2e-5 /
atol 1e-4 (``tests/test_kernels.py``'s f32 tolerance); the encoder, the
forward, prefill's hidden states and both caches and each decode step's
logits 2e-3 (as ``tests/test_torch_models.py`` holds a model: other sum
orders through the layers and the tied head); greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed.sharding import Policy
from repro.models import attention as JA
from repro.models import build as j_build
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_from_jax, params_to_numpy
from repro_torch.models import attention as A
from repro_torch.models import build
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.serving import Request, ServeEngine
from repro_torch.tree import leaves
from jax_cache import release_compiled  # noqa: F401

NAME = "whisper-large-v3-smoke"
POL = Policy()
F32_TOL = dict(rtol=2e-5, atol=1e-4)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(port cfg, reference cfg, reference model, reference params, port
    model on the same weights)."""
    jcfg = j_get_config(NAME)
    jm = j_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(NAME)
    return cfg, jcfg, jm, params, model_from_jax(cfg, _np(params), "cpu")


def _feats(cfg, b, seed):
    return _rand((b, cfg.encoder.seq_len, cfg.d_model), seed)


@pytest.mark.parametrize("n,d", [(64, 128), (448, 1280), (1500, 1280)])
def test_sinusoidal_positions_match_the_reference(n, d):
    """The table at the smoke width and at whisper's (448 decoder
    positions; 1 500), and decode's one row at a position equal to the
    table's row there."""
    got = L.sinusoidal_positions(n, d, "cpu")
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JL.sinusoidal_positions(n, d)),
                               rtol=0, atol=1e-6)
    pos = torch.tensor([0, n // 3, n - 1])
    assert torch.equal(L.sinusoidal(pos, d), got[pos])


def test_model_from_jax_carries_every_weight(pair):
    """Every leaf lands in the port's layers; the port's tree goes back to
    the reference's layout unchanged."""
    cfg, _, _, params, model = pair
    assert len(model.enc_blocks) == cfg.encoder.num_layers
    assert len(model.blocks) == cfg.num_layers
    n_ref = sum(np.size(a) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    back = params_to_numpy(cfg, model.params())
    ref = _np(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_cross_attention_matches_the_reference(pair):
    cfg, jcfg, _, params, model = pair
    p = model.blocks[0].params()["cross_attn"]
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    x, enc = _rand((2, 7, cfg.d_model), 1), _rand((2, 16, cfg.d_model), 2)
    want, (wk, wv) = JA.cross_attn_apply(jcfg, jp, jnp.asarray(x),
                                         enc=jnp.asarray(enc))
    got, (k, v) = A.cross_attn_apply(cfg, p, torch.from_numpy(x),
                                     enc=torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(wk), **F32_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), **F32_TOL)
    again, _ = A.cross_attn_apply(cfg, p, torch.from_numpy(x),
                                  enc_kv=(k, v))
    assert torch.equal(again, got)


def test_encoder_and_forward_match_the_reference(pair):
    cfg, _, jm, params, model = pair
    feats = _feats(cfg, 2, 3)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = JED.encode(cfg, params, jnp.asarray(feats), POL)
    got = ED.encode(cfg, model.params(), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    jh, _ = jm.hidden(params, {"tokens": jnp.asarray(toks),
                               "encoder_feats": jnp.asarray(feats)}, POL)
    th, aux = model.hidden({"tokens": torch.from_numpy(toks),
                            "encoder_feats": torch.from_numpy(feats)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)


def test_prefill_and_decode_match_the_reference(pair):
    """Prefill's hidden states, each layer's self and cross caches, then
    decode steps fed the reference's greedy tokens."""
    cfg, _, jm, params, model = pair
    feats = _feats(cfg, 2, 5)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    cache_len = 16
    jh, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len, POL))(
        params, {"tokens": jnp.asarray(toks),
                 "encoder_feats": jnp.asarray(feats)})
    th, tc = model.prefill(torch.from_numpy(toks), cache_len,
                           encoder_feats=torch.from_numpy(feats))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    assert len(tc) == cfg.num_layers
    for i, c in enumerate(tc):
        for kind in ("self", "cross"):
            for k in ("k", "v"):
                np.testing.assert_allclose(c[kind][k].numpy(),
                                           np.asarray(jc[kind][k][i]),
                                           **MODEL_TOL)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, POL))
    tok = toks[:, -1:]
    for i in range(4):
        pos = np.full((2,), 9 + i, np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        assert tl.dtype == torch.float32 and tuple(tl.shape) == \
            (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_served_tokens_equal_the_reference_engine(pair):
    """Both engines (zero frame embeddings, as the reference engine feeds
    them): three prompts of 3, 8 and 12 tokens, right-padded into one
    grid, 6 new each."""
    cfg, jcfg, _, params, model = pair
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (3, 8, 12)]
    outs = []
    for eng, req in ((JServeEngine(jcfg, params, batch_size=3, cache_len=24),
                      JRequest),
                     (ServeEngine(cfg, model, batch_size=3, cache_len=24,
                                  device="cpu"), Request)):
        reqs = [req(prompt=p, max_new_tokens=6, id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        assert eng.run_once() == 3
        outs.append([r.result for r in reqs])
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_seeded_init_draws_every_leaf():
    """``init`` draws the encoder-decoder's leaves in place: the same seed
    the same weights, ``pos_embed`` at the reference's 0.01 scale, the
    norms at 1 and 0."""
    cfg = get_config(NAME)
    a = build(cfg, device="cpu").init(3).params()
    b = build(cfg, device="cpu").init(3).params()
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert abs(float(a["pos_embed"].std()) - 0.01) < 2e-3
    assert torch.equal(a["enc_layers"][1]["norm2"]["scale"],
                       torch.ones(cfg.d_model))
    assert torch.equal(a["layers"][0]["cross_attn"]["wq"],
                       b["layers"][0]["cross_attn"]["wq"])


def test_training_is_accepted_since_a9_8f():
    """The model trains (ROADMAP A9.8f): ``train_mode`` hands out its
    weights, and one loss on the pipeline's batch (with its frontend
    input) gives every weight a finite gradient; the parity with the
    reference's gradients is ``tests/test_torch_train_layers.py``'s."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticPipeline
    cfg = get_config(NAME)
    model = build(cfg, device="cpu").init(0).train_mode()
    batch = SyntheticPipeline(cfg, ShapeSpec("t", 12, 2, "train"),
                              device="cpu").batch(0)
    model.loss(batch)[0].backward()
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()


@pytest.mark.parametrize("name,given,match", [
    (NAME, {"patch_embeds"}, "takes no"),
    (NAME, {"encoder_feats", "patch_embeds"}, "takes no"),
    (NAME, set(), "needs encoder_feats"),
    ("phi-3-vision-4.2b-smoke", {"encoder_feats"}, "takes no"),
    ("smollm-135m-smoke", {"patch_embeds"}, "takes no")])
def test_prefill_and_hidden_refuse_a_frontend_input_the_model_lacks(
        name, given, match):
    """An input of another architecture's frontend, or the encoder-
    decoder without its frames, raises before any layer runs."""
    cfg = get_config(name)
    model = build(cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    feats = {k: torch.zeros((1, 4, cfg.d_model)) for k in given}
    with pytest.raises(ValueError, match=match):
        model.prefill(toks, 8, **feats)
    with pytest.raises(ValueError, match=match):
        model.hidden({"tokens": toks, **feats})
