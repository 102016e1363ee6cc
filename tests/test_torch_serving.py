"""The port's ServeEngine against the reference's, on the same converted
weights and prompts: the greedy tokens must be equal.

Twins of ``tests/test_runtime.py``'s ``test_serve_engine_batched_requests``
and ``test_serve_engine_event_driven``, for ``smollm-135m-smoke`` (dense
``attn`` layers, prompts of three lengths), ``recurrentgemma-2b-smoke``
(``rglru`` and ``local`` layers), ``rwkv6-1.6b-smoke`` (``rwkv``
layers) and ``kimi-k2-1t-a32b-smoke`` (a dense and an MoE layer, prompts
of three lengths); the recurrent ones with equal-length prompts, as the
engine requires for recurrent layers.  Both run float32 on the CPU; the port's
prefill goes through the plain versions of its kernels.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_from_jax
from repro_torch.models import build
from repro_torch.serving import Request, ServeEngine

#: name -> prompt lengths of one batch
PROMPTS = {"smollm-135m-smoke": (5, 6, 7),
           "recurrentgemma-2b-smoke": (12, 12, 12),
           "rwkv6-1.6b-smoke": (12, 12, 12),
           "kimi-k2-1t-a32b-smoke": (5, 6, 7)}


def _engines(name, batch_size, cache_len):
    jcfg = j_get_config(name)
    params = j_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(name)
    model = model_from_jax(cfg, jax.tree.map(np.asarray, params), "cpu")
    return (JServeEngine(jcfg, params, batch_size=batch_size,
                         cache_len=cache_len),
            ServeEngine(cfg, model, batch_size=batch_size,
                        cache_len=cache_len, device="cpu"), cfg)


def _serve(eng, req_cls, prompts, max_new):
    reqs = [req_cls(prompt=p, max_new_tokens=max_new, id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    assert eng.run_once() == len(reqs)
    assert all(r.done.is_set() for r in reqs)
    return [r.result for r in reqs]


@pytest.mark.parametrize("name", sorted(PROMPTS))
def test_batched_tokens_equal_the_reference_engine(name):
    j_eng, t_eng, cfg = _engines(name, batch_size=3, cache_len=64)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in PROMPTS[name]]
    want = _serve(j_eng, JRequest, prompts, 4)
    got = _serve(t_eng, Request, prompts, 4)
    for w, g in zip(want, got):
        assert g.dtype == np.int32 and g.shape == (4,)
        np.testing.assert_array_equal(g, w)
    # batched result == solo result for the same prompt (greedy decode)
    solo = _serve(t_eng, Request, prompts[:1], 4)
    np.testing.assert_array_equal(solo[0], got[0])


@pytest.mark.parametrize("name", sorted(PROMPTS))
def test_event_driven_engine_serves_on_arrival(name):
    """The engine thread sleeps on the coordinator and serves on arrival;
    its tokens equal the reference engine's."""
    j_eng, t_eng, _ = _engines(name, batch_size=2, cache_len=32)
    prompt = np.array([1, 2, 3], np.int32)
    want = _serve(j_eng, JRequest, [prompt], 3)[0]
    t = threading.Thread(target=t_eng.serve_forever, daemon=True)
    t.start()
    out = t_eng.generate(prompt, max_new_tokens=3)
    t_eng.stop()
    t.join(timeout=30)
    assert not t.is_alive()
    np.testing.assert_array_equal(out, want)


def test_engine_without_a_gpu_raises(monkeypatch):
    """The default device is the GPU: with none visible, building a
    model or an engine raises instead of falling back to the CPU."""
    cfg = get_config("smollm-135m-smoke")
    model = build(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg)


def test_engine_refuses_a_model_on_another_device():
    cfg = get_config("smollm-135m-smoke")
    model = build(cfg, device="meta")
    with pytest.raises(ValueError, match="engine runs on cpu"):
        ServeEngine(cfg, model, device="cpu")
