"""The port's flash_attention op against the reference's Pallas kernel.

On the CPU, ``repro_torch.kernels.flash_attention`` takes its plain
version (``attention_ref`` on KV heads repeated to the query heads); the
reference runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it (``block_q = block_k = 64``).  Both get
the same numpy-seeded inputs.  Tolerances are ``tests/test_kernels.py``'s:
rtol 2e-5 / atol 1e-4 in float32, 2e-2 / 1e-1 in bfloat16 (the two sum
in different orders, and bfloat16 rounds the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from jax_cache import release_compiled  # noqa: F401

#: (b, sq, skv, h, kv, hd): tests/test_kernels.py's shapes, then head dim
#: 256 (recurrentgemma-2b's, 10 query heads on one KV head) and 32 (its
#: smoke config's)
SHAPES = [(2, 128, 128, 4, 4, 64), (1, 200, 200, 4, 2, 32),
          (2, 64, 256, 2, 1, 64), (1, 96, 96, 10, 1, 256),
          (2, 40, 40, 4, 1, 32)]
#: dtype -> (rtol, atol)
TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 1e-1)}
CASES = [(s, causal, dt) for s in SHAPES for causal in (True, False)
         for dt in sorted(TOL) if not (causal and s[1] != s[2])]


def _inputs(b, sq, skv, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("shape,causal,dtype", CASES)
def test_flash_attention_matches_the_pallas_kernel(shape, causal, dtype):
    q, k, v = _inputs(*shape, seed=list(shape))
    want = np.asarray(j_flash(*(jnp.asarray(a, getattr(jnp, dtype))
                                for a in (q, k, v)),
                              causal=causal, block_q=64, block_k=64),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_the_reference_oracle(causal):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((3, 50, 32)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(j_ref(*(jnp.asarray(a) for a in (q, k, v)),
                            causal=causal))
    got = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)


def test_cpu_path_launches_no_kernel():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 32, 0))
    before = LAUNCHES["flash_attention"]
    flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper checks its inputs before it builds or launches
    anything; CPU tensors go to the plain version, never to it."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 32, 0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    assert _build.source("flash_attention").is_file()
