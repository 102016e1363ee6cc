"""The port's training path against the reference's, on the CPU.

smollm-135m-smoke (2 layers, d 128, 4 heads on 2, hd 32, vocab 512,
float32).  Inputs are made with numpy from a seed; weights come from the
reference's ``Model.init`` (``convert.model_from_jax``), so both packages
run on the same numbers.  The reference's ``Policy()`` has no mesh.

Tolerances, each with its reason:

* losses, accuracies, cross entropy: rtol 1e-5 (float32 sums in other
  orders; the reference's logsumexp and attention are blocked);
* gradients: atol 1e-5 + rtol 1e-4 of each leaf (float32 through two
  layers, the 512-way softmax and blocked attention in other orders);
* one AdamW update from identical gradients and moments: rtol 1e-6, atol
  1e-7 (the same float32 operations; XLA may fuse a multiply-add); int8
  codes equal; bfloat16 moments within one bf16 ulp (``MOMENT_TOL``);
* 8 training steps: the printed losses (4 decimals) within 2e-4, the
  final loss rtol 1e-4, the parameters atol 5e-5 (AdamW's first steps
  are close to lr * sign(g), so float32 noise in a gradient near 0 moves
  a weight by up to 2 lr; none did here).
"""
import dataclasses
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as j_optim
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShape
from repro.core import dispatch as JD
from repro.data import SyntheticPipeline as JPipeline
from repro.distributed.sharding import Policy
from repro.launch.train import TrainRun as JRun
from repro.launch.train import run_training as j_run_training
from repro.models import build as j_build
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro_torch import convert, optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import SyntheticPipeline
from repro_torch.distributed import EventCoordinator
from repro_torch.launch.train import TrainRun, make_train_step, run_training
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.tree import flatten as _flat
from repro_torch.tree import leaves, map_leaves
from jax_cache import release_compiled  # noqa: F401

NAME = "smollm-135m-smoke"
POL = Policy()
SHAPE = (4, 64)                     # (global batch, seq len) of the runs
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
#: state dtype -> the tolerance of the moments after one update: float32
#: within a few float32 ulps; bf16 within one bf16 ulp (2^-7 relative),
#: because where XLA fuses the moment's multiply-add the float32 value
#: before the rounding differs by an ulp and can round the other way
MOMENT_TOL = {"float32": dict(rtol=1e-6, atol=1e-9),
              "bfloat16": dict(rtol=2.0 ** -7, atol=1e-9),
              "int8": dict(rtol=1e-6, atol=1e-9)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _with_parallel(cfg, **kw):
    return dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, **kw))


@pytest.fixture(scope="module")
def ref_params():
    cfg = j_get_config(NAME)
    return _np(j_build(cfg).init(jax.random.PRNGKey(0)))


def _batch(cfg, seed, b=2, s=40, masked=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[rng.random((b, s)) < masked / s] = -1
    return {"tokens": toks, "labels": labels}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 17, 64)) * 3).astype(np.float32)
    labels = rng.integers(-1, 64, (3, 17)).astype(np.int32)
    for z in (1e-4, 0.0):
        want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z)
        got = L.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), z)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), **LOSS_TOL)


@pytest.mark.parametrize("chunk", [1024, 16], ids=["one_chunk", "chunked"])
def test_loss_fn_matches_the_reference(ref_params, chunk):
    """Sequence chunks of 16 over 40 tokens: the reference pads the last
    chunk, the port slices it."""
    jcfg, cfg = j_get_config(NAME), get_config(NAME)
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    labels = _batch(cfg, 2)["labels"]
    want = JTF.loss_fn(jcfg, ref_params, jnp.asarray(hidden),
                       jnp.asarray(labels), chunk=chunk)
    params = convert.model_from_jax(cfg, ref_params, "cpu").params()
    got = TF.loss_fn(cfg, params, torch.from_numpy(hidden),
                     torch.from_numpy(labels), chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **LOSS_TOL)


def _port_grads(cfg, ref_params, batch):
    model = convert.model_from_jax(cfg, ref_params, "cpu").train_mode()
    loss, metrics = model.loss({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss.backward()
    grads = map_leaves(lambda p: p.grad, model.params())
    return loss.detach(), metrics, grads


@pytest.fixture(scope="module")
def grads_pair(ref_params):
    """The reference's value_and_grad of Model.loss, and the port's with
    remat off and on, on one batch."""
    jcfg = j_get_config(NAME)
    jm = j_build(jcfg)
    batch = _batch(jcfg, 3)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, POL), has_aux=True))(
            ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = get_config(NAME)
    port = {remat: _port_grads(_with_parallel(cfg, remat=remat), ref_params,
                               batch)
            for remat in (False, True)}
    return (float(jloss), _np(jmet), _np(jgrads)), port


def test_model_loss_matches_the_reference(grads_pair):
    (jloss, jmet, _), port = grads_pair
    for loss, metrics, _ in port.values():
        np.testing.assert_allclose(loss.item(), jloss, **LOSS_TOL)
        np.testing.assert_allclose(float(metrics["acc"]), jmet["acc"],
                                   **LOSS_TOL)
        assert float(metrics["aux"]) == float(jmet["aux"]) == 0.0


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
def test_gradients_match_the_reference_leaf_by_leaf(grads_pair, remat):
    (_, _, jgrads), port = grads_pair
    cfg = get_config(NAME)
    got = convert.params_to_numpy(cfg, port[remat][2])
    want_leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(want_leaves) == len(got_leaves) == 11
    for path, w in want_leaves:
        g = got_leaves[path]
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL + GRAD_RTOL * float(np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))


def test_remat_on_and_off_give_the_same_gradients(grads_pair):
    _, port = grads_pair
    off, on = port[False][2], port[True][2]
    for a, b in zip(leaves(off), leaves(on)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_schedule_matches_the_reference():
    jc = j_optim.AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=20)
    c = optim.AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=20)
    steps = np.arange(0, 25, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: j_optim.schedule(jc, s))(
        jnp.asarray(steps)))
    got = optim.schedule(c, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _opt_tree(seed, like):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.01,
        like)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_one_update_matches_the_reference(ref_params, state_dtype):
    """One AdamW step at step 4 from the same gradients and (non-zero)
    moments: new parameters, moments and metrics."""
    cfg = get_config(NAME)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10,
              state_dtype=state_dtype, grad_clip=0.5)
    jc, c = j_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    grads = _opt_tree(4, ref_params)
    m0, v0 = _opt_tree(5, ref_params), jax.tree.map(
        np.abs, _opt_tree(6, ref_params))
    jstate = j_optim.AdamWState(
        jnp.asarray(3, jnp.int32),
        jax.tree.map(lambda x: j_optim.adamw._store(jnp.asarray(x),
                                                    state_dtype), m0),
        jax.tree.map(lambda x: j_optim.adamw._store(jnp.asarray(x),
                                                    state_dtype), v0))
    jp, js, jmet = jax.jit(lambda g, s, p: j_optim.update(jc, g, s, p))(
        grads, jstate, ref_params)
    jp, js, jmet = _np(jp), _np(js), _np(jmet)

    state = convert.adamw_state_from_jax(cfg, _np(jstate), "cpu")
    params = convert.model_from_jax(cfg, ref_params, "cpu").params()
    tgrads = convert.to_torch(convert._to_layers(cfg, grads), "cpu")
    new_p, new_s, met = optim.update(c, tgrads, state, params)
    np.testing.assert_allclose(float(met["grad_norm"]), jmet["grad_norm"],
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["lr"]), jmet["lr"], rtol=1e-6)
    assert float(met["grad_norm"]) > c.grad_clip       # clipping on
    assert int(new_s.step) == int(js.step) == 4
    got_p = convert.params_to_numpy(cfg, new_p)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, w, rtol=1e-6, atol=1e-7), got_p, jp)
    gm, gv = convert.adamw_state_to_numpy(cfg, new_s)[1:]
    for got, want in ((gm, js.m), (gv, js.v)):
        gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl) == (22 if state_dtype == "int8" else 11)
        for g, w in zip(gl, wl):
            if w.dtype == np.int8:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                           **MOMENT_TOL[state_dtype])


def test_global_norm_and_clipping():
    tree = {"a": torch.full((3, 4), 2.0), "b": [torch.full((5,), -1.0)]}
    assert float(optim.global_norm(tree)) == pytest.approx(np.sqrt(53.0))
    c = optim.AdamWConfig(lr=1.0, warmup_steps=0, total_steps=1,
                          weight_decay=0.0, grad_clip=1.0, eps=0.0,
                          min_lr_frac=1.0)
    params = {"a": torch.zeros(3, 4), "b": [torch.zeros(5)]}
    grads = {"a": torch.full((3, 4), 1e3), "b": [torch.full((5,), -1e3)]}
    new, st, met = optim.update(c, grads, optim.init(c, params), params)
    # clipped to norm 1, then Adam's first step is lr * sign(g)
    assert float(met["grad_norm"]) == pytest.approx(1e3 * np.sqrt(17.0))
    assert torch.allclose(new["a"], torch.full((3, 4), -1.0))
    assert torch.allclose(new["b"][0], torch.full((5,), 1.0))
    assert float(st.m["a"][0, 0]) == pytest.approx(
        0.1 * 1e3 / (1e3 * np.sqrt(17.0)), rel=1e-6)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_pipeline_batches_match_the_reference():
    jcfg, cfg = j_get_config(NAME), get_config(NAME)
    jp = JPipeline(jcfg, JShape("t", 33, 3, "train"))
    p = SyntheticPipeline(cfg, ShapeSpec("t", 33, 3, "train"), device="cpu")
    for step in (0, 1, 7, 1000):
        want, got = jp.batch(step), p.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(
            p.token_histogram(got, 64).numpy(),
            np.asarray(jp.token_histogram(want, 64)))
        np.testing.assert_array_equal(
            p.token_histogram(got).numpy(),
            np.asarray(JD.histogram(jnp.asarray(want["tokens"]).reshape(-1)
                                    % 256, 256)))


@pytest.mark.parametrize("name,b,s", [
    ("whisper-large-v3-smoke", 3, 33), ("phi-3-vision-4.2b-smoke", 3, 33),
    ("whisper-large-v3", 1, 8), ("phi-3-vision-4.2b", 2, 8)])
def test_pipeline_frontend_batches_match_the_reference(name, b, s):
    """The encoder-decoder's ``encoder_feats`` and the VLM's
    ``patch_embeds``, drawn after the tokens from the same generator: every
    key, dtype and bit the reference's (float32 in the smoke configs,
    bfloat16 at full width: 1 500 frames, 256 patches)."""
    jcfg, cfg = j_get_config(name), get_config(name)
    jp = JPipeline(jcfg, JShape("t", s, b, "train"))
    p = SyntheticPipeline(cfg, ShapeSpec("t", s, b, "train"), device="cpu")
    frontend = "encoder_feats" if cfg.frontend == "audio" else "patch_embeds"
    for step in (0, 5):
        want, got = jp.batch(step), p.batch(step)
        assert set(got) == set(want) == {"tokens", "labels", frontend}
        for k in want:
            w = np.asarray(want[k])
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
            assert tuple(got[k].shape) == w.shape, k
            if got[k].dtype == torch.bfloat16:
                np.testing.assert_array_equal(
                    got[k].view(torch.int16).numpy(), w.view(np.int16))
            else:
                np.testing.assert_array_equal(got[k].numpy(), w)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.randn(3, 4).bfloat16()},
            "q": (torch.zeros((2, 2), dtype=torch.int8), torch.ones((2, 1))),
            "opt": optim.AdamWState(torch.tensor(3, dtype=torch.int32),
                                    {"w": [torch.ones(2)]},
                                    {"w": [torch.zeros(2)]})}
    ck.save(7, tree, wait=True)
    assert ck.latest_step() == 7
    restored = ck.restore(7, tree)
    assert isinstance(restored["opt"], optim.AdamWState)
    assert isinstance(restored["q"], tuple)
    for (p, a), (q, b) in zip(_flat(tree), _flat(restored)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b)


def test_torn_save_is_invisible(tmp_path):
    """A crash mid-save (no manifest) must not be picked up by latest_step."""
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"x": torch.ones(4)}, wait=True)
    os.makedirs(tmp_path / "step_000000009", exist_ok=True)
    os.makedirs(tmp_path / "step_000000011.tmp", exist_ok=True)
    assert ck.latest_step() == 3


def test_async_save_notifies_its_coordinator(tmp_path):
    coord = EventCoordinator()
    seen = []
    coord.subscribe("checkpoint_saved", lambda step: seen.append(step))
    ck = Checkpointer(str(tmp_path), coord)
    ck.save(5, {"x": torch.ones(1000)})
    assert coord.wait("checkpoint_saved", timeout=30) == {"step": 5}
    ck.wait()
    assert seen == [5] and ck.latest_step() == 5


def test_save_in_flight_keeps_the_weights_of_its_step(tmp_path,
                                                     monkeypatch):
    """A train step runs while the async save of the step before it is
    still writing; the checkpoint holds the weights it was given, not the
    ones the step wrote over them in place."""
    cfg = get_config(NAME)
    model = build(cfg, "cpu").init(0).train_mode()
    opt_cfg = optim.AdamWConfig(state_dtype=cfg.parallel.opt_state_dtype)
    step = make_train_step(model, opt_cfg)
    pipe = SyntheticPipeline(cfg, ShapeSpec("smoke", 16, 2, "train"),
                             device="cpu")
    state = step(optim.init(opt_cfg, model.params()), pipe.batch(0))[0]
    saved = map_leaves(torch.clone, model.params())
    release, save = threading.Event(), np.save
    monkeypatch.setattr(np, "save", lambda *a, **k: (
        release.wait(30), save(*a, **k)))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": model.params(), "opt": state})
    step(state, pipe.batch(1))
    release.set()
    ck.wait()
    got = ck.restore(1, {"params": saved, "opt": state})["params"]
    assert not torch.equal(leaves(saved)[0], leaves(model.params())[0])
    for (p, a), (q, c) in zip(_flat(saved), _flat(got)):
        assert p == q and torch.equal(a, c), p


@pytest.mark.parametrize("state_dtype", ["bfloat16", "int8"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, ref_params,
                                                     state_dtype):
    """The reference's Checkpointer writes {params, AdamWState} (bf16 as
    ml_dtypes, int8 moments as (q, scale) pairs); the port reads it."""
    jcfg, cfg = j_get_config(NAME), get_config(NAME)
    jc = j_optim.AdamWConfig(state_dtype=state_dtype)
    params = jax.tree.map(jnp.asarray, ref_params)
    params["embed"] = params["embed"].astype(jnp.bfloat16)
    m = jax.tree.map(lambda x: j_optim.adamw._store(jnp.asarray(x),
                                                    state_dtype),
                     _opt_tree(8, ref_params))
    jstate = j_optim.AdamWState(jnp.asarray(6, jnp.int32), m, m)
    JCheckpointer(str(tmp_path)).save(6, {"params": params, "opt": jstate},
                                      wait=True)
    got = convert.load_jax_checkpoint(cfg, str(tmp_path), 6, "cpu",
                                     state_dtype)
    assert got["params"]["embed"].dtype == torch.bfloat16
    want_p = _np(params)
    np.testing.assert_array_equal(got["params"]["embed"].float().numpy(),
                                  np.asarray(want_p["embed"], np.float32))
    model = build(cfg, "cpu").load_params(got["params"])
    np.testing.assert_array_equal(
        model.params()["layers"][1]["attn"]["wq"].numpy(),
        want_p["segments"][0]["u0"]["attn"]["wq"][1])
    assert int(got["opt"].step) == 6
    gm = convert.adamw_state_to_numpy(cfg, got["opt"])[1]
    want_m = _np(jstate.m)
    for g, w in zip(jax.tree.leaves(gm), jax.tree.leaves(want_m)):
        np.testing.assert_array_equal(g, np.asarray(w, g.dtype))


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

_LOSS_LINE = re.compile(r"step\s+(\d+) loss=([-\d.]+)")


def _losses(text):
    return {int(s): float(v) for s, v in _LOSS_LINE.findall(text)}


def _run_both(tmp_path, capsys, ref_params, accum_steps):
    jcfg = _with_parallel(j_get_config(NAME), accum_steps=accum_steps)
    cfg = _with_parallel(get_config(NAME), accum_steps=accum_steps)
    b, s = SHAPE
    kw = dict(steps=8, log_every=1, ckpt_every=100)
    jout = j_run_training(JRun(cfg=jcfg, shape=JShape("smoke", s, b, "train"),
                               **kw), resume=False)
    jlog = capsys.readouterr().out
    # the port starts from the reference's weights: its step-0 checkpoint
    model = convert.model_from_jax(cfg, ref_params, "cpu")
    opt_cfg = optim.AdamWConfig(state_dtype=cfg.parallel.opt_state_dtype)
    Checkpointer(str(tmp_path)).save(
        0, {"params": model.params(),
            "opt": optim.init(opt_cfg, model.params())}, wait=True)
    out = run_training(TrainRun(cfg=cfg, shape=ShapeSpec("smoke", s, b,
                                                         "train"),
                                ckpt_dir=str(tmp_path), device="cpu", **kw))
    return jout, _losses(jlog), out, _losses(capsys.readouterr().out)


@pytest.mark.parametrize("accum_steps", [1, 2], ids=["one", "accum2"])
def test_run_training_matches_the_reference(tmp_path, capsys, ref_params,
                                            accum_steps):
    jout, jlosses, out, losses = _run_both(tmp_path, capsys, ref_params,
                                           accum_steps)
    assert sorted(losses) == sorted(jlosses) == list(range(1, 9))
    for step in jlosses:
        assert abs(losses[step] - jlosses[step]) <= 2e-4, step
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=1e-4)
    np.testing.assert_allclose(out["grad_norm"], jout["grad_norm"],
                               rtol=1e-3)
    cfg = get_config(NAME)
    got = convert.params_to_numpy(cfg, out["params"])
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=0, atol=5e-5), got, _np(jout["params"]))


def test_failure_resume_bit_identical(tmp_path):
    """Kill training mid-run, resume from its checkpoint, and land on the
    SAME bits as an uninterrupted run (deterministic pipeline, optimizer
    and kernels)."""
    cfg = get_config(NAME)
    b, s = SHAPE
    kw = dict(cfg=cfg, shape=ShapeSpec("smoke", s, b, "train"), steps=8,
              ckpt_every=2, log_every=100, device="cpu")
    ref = run_training(TrainRun(ckpt_dir=str(tmp_path / "a"), **kw))
    run_b = TrainRun(ckpt_dir=str(tmp_path / "b"), **kw)
    with pytest.raises(RuntimeError, match="simulated failure"):
        run_training(run_b, crash_at=5)
    resumed = run_training(run_b, resume=True)
    assert resumed["loss"] == ref["loss"]
    for (p, a), (q, c) in zip(_flat(ref["params"]), _flat(resumed["params"])):
        assert p == q and torch.equal(a, c), p
    for (p, a), (q, c) in zip(_flat(ref["opt_state"]),
                              _flat(resumed["opt_state"])):
        assert p == q and torch.equal(a, c), p


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,item", [
    ("rwkv6-1.6b", "A9.8c"), ("kimi-k2-1t-a32b", "A9.8d"),
    ("deepseek-v3-671b", "A9.8e")])
def test_untrainable_configs_are_refused(name, item):
    cfg = get_config(name + "-smoke")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        run_training(TrainRun(cfg=cfg, shape=ShapeSpec("t", 8, 1, "train"),
                              steps=1, device="cpu"))


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "whisper-large-v3",
                                  "phi-3-vision-4.2b", "stablelm-3b"])
def test_trainable_configs_are_accepted(name):
    """The local and rglru layers (A9.8a, b), the encoder-decoder and the
    VLM (A9.8f) train: ``train_mode`` hands their weights out."""
    model = build(get_config(name + "-smoke"), "cpu").train_mode()
    assert all(p.requires_grad for p in model.parameters())


def test_mla_model_is_refused():
    """MLA with a dense FFN (no MoE to refuse first): its flash backward
    at q/k 192, v 128 is ROADMAP A9.8e."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b-smoke"), moe=None)
    with pytest.raises(NotImplementedError, match="ROADMAP A9.8e"):
        build(cfg, "cpu").train_mode()


def test_rglru_only_model_trains():
    """A model of rglru layers alone: every weight gets a finite, non-zero
    gradient through the scan's backward (A9.8b)."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b-smoke"),
                              block_pattern=("rglru",), num_layers=2)
    model = build(cfg, "cpu").init(0).train_mode()
    batch = SyntheticPipeline(cfg, ShapeSpec("t", 12, 2, "train"),
                              device="cpu").batch(0)
    model.loss(batch)[0].backward()
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
    for lp in model.params()["layers"]:
        assert all(float(g.grad.abs().max()) > 0
                   for g in leaves(lp["rglru"]))


def test_a_mesh_is_refused():
    run = TrainRun(cfg=get_config(NAME), shape=ShapeSpec("t", 8, 1, "train"),
                   steps=1, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A9.6"):
        run_training(run)


def test_serving_weights_stay_frozen():
    model = build(get_config(NAME), "cpu").init(0)
    assert not any(p.requires_grad for p in model.parameters())
    model.train_mode()
    assert all(p.requires_grad for p in model.parameters())
    model.train_mode(False)
    assert not any(p.requires_grad for p in model.parameters())


def test_main_sets_the_allocator_setting(monkeypatch, capsys):
    """The CLI sets the caching allocator's setting before the run (unless
    the environment holds one) and trains the smoke config."""
    from repro_torch.launch import train
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "placeholder")
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF")
    train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1",
                "--device", "cpu"])
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == train.CUDA_ALLOC_CONF
    assert "loss" in capsys.readouterr().out
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "backend:native")
    train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1",
                "--device", "cpu"])
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "backend:native"
