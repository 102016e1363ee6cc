"""The port's grouped_matmul op against the reference's Pallas kernel.

On the CPU, ``repro_torch.kernels.grouped_matmul`` takes its plain
version (an f32 einsum cast to x's dtype); the reference runs its Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it
(``block_c = block_f = block_d = 64``), and its oracle
``grouped_matmul_ref``.  Both get the same numpy-seeded inputs.
Tolerances are ``tests/test_kernels.py``'s: rtol 1e-4 in float32 and
3e-2 in bfloat16, atol ten times that (the sums run in other orders, and
bfloat16 rounds the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul import grouped_matmul as j_gmm
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as j_ref
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_ref)
from repro_torch.kernels.grouped_matmul.kernel import grouped_matmul_cuda
from jax_cache import release_compiled  # noqa: F401

#: (e, c, d, f): tests/test_kernels.py's shapes, then an odd one (no
#: dimension a multiple of 8: the kernel's ragged edges)
SHAPES = [(4, 64, 128, 256), (8, 100, 96, 64), (1, 256, 512, 128),
          (3, 37, 100, 70)]
#: dtype -> rtol (atol is ten times it)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(e, c, d, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, d)).astype(np.float32),
            rng.standard_normal((e, d, f)).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_matmul_matches_the_pallas_kernel(shape, dtype):
    x, w = _inputs(*shape, seed=list(shape))
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    want = np.asarray(j_gmm(jx, jw, block_c=64, block_f=64, block_d=64),
                      np.float32)
    want_ref = np.asarray(j_ref(jx, jw), np.float32)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    got = grouped_matmul(tx, tw)
    assert got.dtype == tx.dtype
    assert tuple(got.shape) == (shape[0], shape[1], shape[3])
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * 10)
    np.testing.assert_allclose(got.float().numpy(), want_ref, rtol=tol,
                               atol=tol * 10)


def test_plain_version_sums_in_float32():
    """bf16 inputs are multiplied and summed in f32 and rounded once:
    the result equals the f32 product of the same (bf16) values, rounded
    to bf16."""
    x, w = _inputs(2, 5, 300, 7, seed=3)
    tx, tw = (torch.from_numpy(a).bfloat16() for a in (x, w))
    got = grouped_matmul_ref(tx, tw)
    want = torch.einsum("ecd,edf->ecf", tx.float(), tw.float()).bfloat16()
    assert torch.equal(got, want)


def test_cpu_path_launches_no_kernel():
    x, w = (torch.from_numpy(a) for a in _inputs(2, 8, 16, 24, 0))
    before = LAUNCHES["grouped_matmul"]
    out = grouped_matmul(x, w)
    assert LAUNCHES["grouped_matmul"] == before
    assert torch.equal(out, grouped_matmul_ref(x, w))


def test_other_devices_are_refused():
    x, w = (torch.empty((2, 8, 16), device="meta"),
            torch.empty((2, 16, 4), device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        grouped_matmul(x, w)


@pytest.mark.parametrize("case,match", [
    ("float16", "float32 or both bfloat16"),
    ("mixed", "float32 or both bfloat16"),
    ("shape", r"need x \(E, C, d\) and w \(E, d, f\)"),
    ("empty", "every dimension >= 1"),
    ("experts", "E <= 65535"),
    ("strided", "contiguous"),
    ("misaligned", "16-byte boundaries"),
    ("cpu", "CUDA tensors"),
])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """The wrapper checks its inputs before it builds or launches
    anything; CPU tensors go to the plain version, never to it."""
    x, w = torch.zeros((2, 8, 16)), torch.zeros((2, 16, 24))
    if case == "float16":
        x, w = x.half(), w.half()
    elif case == "mixed":
        w = w.bfloat16()
    elif case == "shape":
        w = torch.zeros((2, 15, 24))
    elif case == "empty":
        x, w = torch.zeros((2, 0, 16)), torch.zeros((2, 16, 24))
    elif case == "experts":
        x = torch.zeros((1, 8, 16)).expand(70000, 8, 16)
        w = torch.zeros((1, 16, 24)).expand(70000, 16, 24)
    elif case == "strided":
        x = torch.zeros((2, 16, 8)).transpose(1, 2)
    elif case == "misaligned":
        x = torch.zeros(2 * 8 * 16 + 1)[1:].view(2, 8, 16)
    before = LAUNCHES["grouped_matmul"]
    with pytest.raises(ValueError, match=match):
        grouped_matmul_cuda(x, w)
    assert LAUNCHES["grouped_matmul"] == before
    assert _build.source("grouped_matmul").is_file()
