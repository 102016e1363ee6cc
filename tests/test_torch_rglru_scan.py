"""The port's rglru_scan op against the reference's Pallas kernel.

On the CPU, ``repro_torch.kernels.rglru_scan`` takes its plain version
(the recurrence walked in order); the reference runs its Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` runs it.  Both get the
same numpy-seeded inputs and are held to that file's 1e-4 (the two sum
in different orders).  The twin of ``test_rglru_matches_model_block``
holds the port's RG-LRU block, which takes ``h`` from the op, against
the reference's block, which takes it from an associative scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.rglru_scan import rglru_scan as j_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as j_ref
from repro.models import rglru as JRG
from repro_torch.configs import get_config
from repro_torch.convert import to_torch
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from jax_cache import release_compiled  # noqa: F401


def _inputs(t, b, w, seed):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-(rng.standard_normal((t, b, w)) + 2.0)))
    x = rng.standard_normal((t, b, w)) * 0.3
    h0 = rng.standard_normal((b, w))
    return (a.astype(np.float32), x.astype(np.float32),
            h0.astype(np.float32))


@pytest.mark.parametrize("t,b,w", [(64, 2, 128), (100, 3, 60), (256, 1, 256),
                                   (40, 2, 128)])
def test_rglru_scan_matches_the_pallas_kernel(t, b, w):
    a, x, h0 = _inputs(t, b, w, seed=[t, b, w])
    want = np.asarray(j_scan(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0),
                             block_c=32, block_b=2, block_w=64))
    got = rglru_scan(*(torch.from_numpy(v) for v in (a, x, h0)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, b, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_ref(jnp.asarray(a), jnp.asarray(x),
                                      jnp.asarray(h0))),
        rtol=1e-4, atol=1e-4)


def test_rglru_block_matches_the_reference_block():
    """The port's RG-LRU block (``h`` through ``rglru_scan``) agrees with
    the reference's (``h`` through an associative scan) on the same
    weights and inputs, and so does the kernel path recomposed by hand,
    as in ``test_rglru_matches_model_block``."""
    jcfg = j_get_config("recurrentgemma-2b-smoke")
    cfg = get_config("recurrentgemma-2b-smoke")
    jp = JRG.rglru_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                   (2, 40, cfg.d_model)) * 0.5)
    out_model, st_model = JRG.rglru_apply(jcfg, jp, jnp.asarray(x),
                                          JRG.state_init(jcfg, 2))
    p = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tx = torch.from_numpy(x)
    state = RG.state_init(cfg, 2, "cpu")
    out, st = RG.rglru_apply(cfg, p, tx, state)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_model),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st["h"].numpy(), np.asarray(st_model["h"]),
                               rtol=2e-4, atol=2e-4)
    y, _ = RG._conv1d_causal(tx @ p["w_in"], p["conv_w"], p["conv_b"],
                             state["conv"])
    a, b = RG._gates(p, y.float())
    h = rglru_scan(a.transpose(0, 1), b.transpose(0, 1),
                   state["h"]).transpose(0, 1)
    gate = L.gelu(tx @ p["w_gate"])
    out_kernel = (h.to(tx.dtype) * gate) @ p["w_proj"]
    np.testing.assert_allclose(out_kernel.numpy(), np.asarray(out_model),
                               rtol=2e-4, atol=2e-4)


def test_cpu_path_launches_no_kernel():
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(8, 1, 4, 0))
    before = LAUNCHES["rglru_scan"]
    assert torch.equal(rglru_scan(a, x, h0), rglru_scan_ref(a, x, h0))
    assert LAUNCHES["rglru_scan"] == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper checks its inputs before it builds or launches
    anything; CPU tensors go to the plain version, never to it."""
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(8, 1, 4, 0))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_cuda(a, x, h0)
    assert _build.source("rglru_scan").is_file()


@pytest.mark.parametrize("t,b,w", [(1, 2, 60), (130, 2, 200), (65, 3, 6)])
def test_rglru_scan_takes_the_models_strided_views(t, b, w):
    """The (T, B, w) views of (B, T, w) tensors that ``rglru_apply`` hands
    the op give the values of contiguous copies and of the reference
    oracle, and h comes back with a's strides, so the model's transpose
    back to (B, T, w) is contiguous."""
    a, x, h0 = _inputs(t, b, w, seed=[t, b, w, 1])
    a_bt, x_bt = (torch.from_numpy(np.ascontiguousarray(v.transpose(1, 0, 2)))
                  for v in (a, x))
    a_view, x_view = a_bt.transpose(0, 1), x_bt.transpose(0, 1)
    got = rglru_scan(a_view, x_view, torch.from_numpy(h0))
    want = rglru_scan(a_view.contiguous(), x_view.contiguous(),
                      torch.from_numpy(h0))
    assert torch.equal(got, want)
    assert got.stride() == a_view.stride()
    assert got.transpose(0, 1).is_contiguous()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_ref(jnp.asarray(a), jnp.asarray(x),
                                      jnp.asarray(h0))),
        rtol=1e-4, atol=1e-4)


def _refused(kind):
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(8, 2, 4, 0))
    if kind == "stride along w":
        return (torch.from_numpy(np.ascontiguousarray(
            a.numpy().transpose(0, 2, 1))).transpose(1, 2), x, h0), "unit stride"
    if kind == "dtype":
        return (a.double(), x, h0), "float32"
    if kind == "shape":
        return (a, x[:, :1], h0), "need a, b"
    if kind == "empty":
        return (a[:0], x[:0], h0), "T, B, w >= 1"
    return (a, x, h0), "CUDA"


@pytest.mark.parametrize("kind", ["stride along w", "dtype", "shape",
                                  "empty", "cpu tensors"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(kind):
    """The wrapper's checks raise before it builds or launches anything:
    a non-unit stride along w (the op copies such inputs first), another
    dtype, mismatched shapes, an empty scan, CPU tensors."""
    args, match = _refused(kind)
    before = LAUNCHES["rglru_scan"]
    with pytest.raises(ValueError, match=match):
        rglru_scan_cuda(*args)
    assert LAUNCHES["rglru_scan"] == before


def test_rglru_block_gradient_matches_the_reference_vjp():
    """The port's RG-LRU block differentiated through ``RglruScan`` (the
    scan's gradient, ``rglru_scan_bwd_ref`` here) against ``jax.vjp`` of
    the reference's block (an associative scan), at a ragged 70 steps,
    past the smoke config's window of 64: the input's and every
    weight's gradient, within ``test_torch_train.py``'s tolerances."""
    jcfg = j_get_config("recurrentgemma-2b-smoke")
    cfg = get_config("recurrentgemma-2b-smoke")
    jp = JRG.rglru_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 70, cfg.d_model)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((2, 70, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda v: v + 0.1 * jnp.asarray(rng.standard_normal(
        v.shape), v.dtype) if v.ndim == 1 else v, jp)   # gates off zero
    _, vjp = jax.vjp(lambda p_, x_: JRG.rglru_apply(
        jcfg, p_, x_, JRG.state_init(jcfg, 2))[0], jp, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(dy))
    p = {k: v.requires_grad_() for k, v in
         to_torch(jax.tree.map(np.asarray, jp), "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = RG.rglru_apply(cfg, p, tx, RG.state_init(cfg, 2, "cpu"))
    assert any("RglruScan" in type(n).__name__ for n in _graph(out.grad_fn))
    out.backward(torch.from_numpy(dy))
    for name, g, w in [("x", tx.grad, want_x)] + [
            (k, p[k].grad, want_p[k]) for k in sorted(p)]:
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4, atol=1e-5 + 1e-4 * np.abs(w).max(),
            err_msg=name)


def _graph(fn):
    """Every node of the autograd graph below ``fn``."""
    seen, todo = [], [fn]
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.append(n)
        todo.extend(f for f, _ in n.next_functions)
    return seen


@pytest.mark.parametrize("t,b,w", [(1, 2, 5), (37, 3, 8)])
def test_scan_gradient_is_the_adjoint_recurrence(t, b, w):
    """``RglruScan``'s gradients of a, b and h0 against torch autograd
    through the recurrence walked as differentiable steps (float32, the
    same operations; 1e-6)."""
    ins = [torch.from_numpy(v).requires_grad_()
           for v in _inputs(t, b, w, seed=[t, b, w, 2])]
    dy = torch.from_numpy(_inputs(t, b, w, seed=[t, b, w, 3])[1])
    rglru_scan(*ins).backward(dy)
    got = [v.grad for v in ins]
    ref = [v.detach().clone().requires_grad_() for v in ins]
    h, hs = ref[2], []
    for i in range(t):
        h = ref[0][i] * h + ref[1][i]
        hs.append(h)
    torch.stack(hs).backward(dy)
    for name, g, v in zip(("a", "b", "h0"), got, ref):
        np.testing.assert_allclose(g.numpy(), v.grad.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
