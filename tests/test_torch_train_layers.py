"""Training the layers of the twenty-first slice against the reference,
on the CPU: recurrentgemma-2b-smoke (one ``rglru, rglru, local`` unit:
the scan's gradient and the flash op's band past the smoke window of
64), whisper-large-v3-smoke (the encoder-decoder: 2 encoder and 2
decoder layers over 16 frames, the flash op's gradient non-causal at Sq
!= Skv in the cross-attention) and phi-3-vision-4.2b-smoke (the VLM: 8
patches spliced over the first positions).

Weights come from the reference's ``Model.init`` (``convert.
model_from_jax``) and the batch from each package's own pipeline (bit
for bit the same: ``test_torch_train.py``), so both run on the same
numbers.  The reference's ``jax.value_and_grad(model.loss)`` is jitted
once per model in a module-scoped fixture.  Tolerances are
``tests/test_torch_train.py``'s: the loss rtol 1e-5, each gradient leaf
atol 1e-5 + rtol 1e-4 of its largest element.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.data import SyntheticPipeline as JPipeline
from repro.distributed.sharding import Policy
from repro.models import build as j_build
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticPipeline
from repro_torch.tree import leaves, map_leaves
from jax_cache import release_compiled  # noqa: F401

POL = Policy()
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

#: name -> (config fields replaced in both packages, (batch, seq len)):
#: one layer unit of recurrentgemma at 80 tokens (past its window of
#: 64); whisper's decoder at 24 tokens against 16 frames; phi's 8 patches
#: under 20 tokens
MODELS = {"recurrentgemma-2b-smoke": (dict(num_layers=3), (2, 80)),
          "whisper-large-v3-smoke": ({}, (2, 24)),
          "phi-3-vision-4.2b-smoke": ({}, (2, 20))}


def _cfgs(name, remat=False):
    fields, _ = MODELS[name]
    out = []
    for cfg in (j_get_config(name), get_config(name)):
        cfg = dataclasses.replace(cfg, **fields)
        out.append(dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, remat=remat)))
    return out


def _port_grads(cfg, params, batch):
    model = convert.model_from_jax(cfg, params, "cpu").train_mode()
    loss, metrics = model.loss(batch)
    loss.backward()
    return float(loss.detach()), float(metrics["acc"]), \
        map_leaves(lambda p: p.grad, model.params())


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """One model: the reference's loss, accuracy and gradients, and the
    port's with remat off and on, from the same weights and batch."""
    name = request.param
    jcfg, cfg = _cfgs(name)
    b, s = MODELS[name][1]
    jbatch = JPipeline(jcfg, JShape("t", s, b, "train")).batch(0)
    batch = SyntheticPipeline(cfg, ShapeSpec("t", s, b, "train"),
                              device="cpu").batch(0)
    jm = j_build(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jm.loss(p, bt, POL), has_aux=True))(params, jbatch)
    port = {remat: _port_grads(_cfgs(name, remat)[1], params, batch)
            for remat in (False, True)}
    return (name, cfg, float(jloss), float(jmet["acc"]),
            jax.tree.map(np.asarray, jgrads), port)


def test_loss_matches_the_reference(pair):
    _, _, jloss, jacc, _, port = pair
    for loss, acc, _ in port.values():
        np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
        np.testing.assert_allclose(acc, jacc, **LOSS_TOL)


def test_gradients_match_the_reference_leaf_by_leaf(pair):
    name, cfg, _, _, jgrads, port = pair
    got = convert.params_to_numpy(cfg, port[False][2])
    want_leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(want_leaves) == len(got_leaves) > 10
    for path, w in want_leaves:
        g = got_leaves[path]
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert np.abs(w).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL + GRAD_RTOL * float(np.abs(w).max()),
            err_msg=f"{name} {jax.tree_util.keystr(path)}")


def test_remat_on_and_off_give_the_same_gradients(pair):
    """Recomputing each layer (the encoder's too) in the backward gives
    the gradients of the run that keeps them, to float32 rounding: the
    CPU's multithreaded kernels (the embedding's backward among them) may
    sum in another order from one call to the next under load, so the
    leaves are held to 1e-6 of their largest element, not to the bit."""
    port = pair[-1]
    for a, b in zip(leaves(port[False][2]), leaves(port[True][2])):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * scale)
