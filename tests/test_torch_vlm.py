"""The port's VLM frontend: ``phi-3-vision-4.2b-smoke`` (2 layers, d 128,
4 heads of 32, 8 patches, float32) against the reference, with its
weights converted (``convert.model_from_jax``; the decoder-only tree).

The frontend is a stub in both packages: precomputed patch embeddings
``(B, P, d)`` replace the token embeddings of the first ``min(P, S)``
positions (``transformer.prefill`` and ``forward``).  Cases: 8 patches
over prompts of 4 tokens (the patches cut to the prompt) and of 12 (text
after the patches), and no patches (text only); both engines, which feed
zero patches over the first ``min(num_patches, longest prompt)``
positions, on prompts shorter and longer than the patches.  Tolerances
as ``tests/test_torch_models.py`` holds a model: 2e-3 for hidden states,
caches and logits; greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed.sharding import Policy
from repro.models import build as j_build
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_from_jax, unstack_segments
from repro_torch.models import build
from repro_torch.serving import Request, ServeEngine
from jax_cache import release_compiled  # noqa: F401

NAME = "phi-3-vision-4.2b-smoke"
POL = Policy()
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = j_get_config(NAME)
    jm = j_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(NAME)
    return cfg, jcfg, jm, params, model_from_jax(cfg, _np(params), "cpu")


def _inputs(cfg, s, seed, patches=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    pe = (rng.standard_normal((2, cfg.num_patches, cfg.d_model)) * 0.5
          ).astype(np.float32) if patches else None
    return toks, pe


@pytest.mark.parametrize("s,patches", [(4, True), (12, True), (12, False)],
                         ids=["prompt4", "prompt12", "text_only"])
def test_prefill_and_forward_match_the_reference(pair, s, patches):
    """Prefill's hidden states and caches, one decode step's logits, and
    the training forward's hidden states, with the patches spliced."""
    cfg, _, jm, params, model = pair
    assert cfg.num_patches == 8 and cfg.resolved_head_dim == 32
    toks, pe = _inputs(cfg, s, seed=s + patches)
    batch = {"tokens": jnp.asarray(toks)}
    kw = {}
    if patches:
        batch["patch_embeds"] = jnp.asarray(pe)
        kw["patch_embeds"] = torch.from_numpy(pe)
    cache_len = s + 4
    jh, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len, POL))(
        params, batch)
    th, tc = model.prefill(torch.from_numpy(toks), cache_len, **kw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    for want, got in zip(unstack_segments(cfg, _np(jc)), tc):
        for k in ("k", "v"):
            np.testing.assert_allclose(got["attn"][k].numpy(),
                                       want["attn"][k], **MODEL_TOL)
    tok, pos = toks[:, -1:], np.full((2,), s, np.int32)
    jl, _ = jm.decode_step(params, jc, jnp.asarray(tok), jnp.asarray(pos),
                           POL)
    tl, _ = model.decode_step(tc, torch.from_numpy(tok),
                              torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    jf, _ = jm.hidden(params, batch, POL)
    tf, _ = model.hidden(dict(tokens=torch.from_numpy(toks), **kw))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **MODEL_TOL)
    if patches:       # the patches are what the first positions see
        p = min(s, cfg.num_patches)
        plain, _ = model.prefill(torch.from_numpy(toks), cache_len)
        assert not torch.allclose(plain[:, :p], th[:, :p])


@pytest.mark.parametrize("lengths", [(3, 6, 5), (4, 12, 9)],
                         ids=["under_the_patches", "past_the_patches"])
def test_served_tokens_equal_the_reference_engine(pair, lengths):
    """Both engines, zero patches over the first min(8, longest prompt)
    positions: prompts all shorter than the patches (the tokens never
    reach the model), and prompts with text after them; 5 new each."""
    cfg, jcfg, _, params, model = pair
    rng = np.random.RandomState(sum(lengths))
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lengths]
    outs = []
    for eng, req in ((JServeEngine(jcfg, params, batch_size=3, cache_len=24),
                      JRequest),
                     (ServeEngine(cfg, model, batch_size=3, cache_len=24,
                                  device="cpu"), Request)):
        reqs = [req(prompt=p, max_new_tokens=5, id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        assert eng.run_once() == 3
        outs.append([r.result for r in reqs])
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)


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
