"""The rounding points of the bf16 tensor-core kernels, emulated on the CPU.

``csrc/flash_attention.cu`` and ``csrc/grouped_matmul.cu`` run their
bf16 products on tensor cores (``mma.sync.m16n8k16``, bf16 x bf16 ->
f32).  A CUDA kernel cannot run here, so this file repeats, in plain
torch, every place where those designs round or order a sum differently
from the plain versions, and holds the result against the JAX package's
oracles (``repro.kernels.flash_attention.ref``,
``repro.kernels.grouped_matmul.ref``) on numpy-seeded inputs, under the
card's tolerances (``chip_smoke.FLASH_TOL``/``GMM_TOL`` for bf16):

* flash: bf16 operands, f32 scores of exact products, ``scale`` after the
  product, the online softmax over the kernel's 32-key tiles, P rounded
  to bf16 once with the denominator summing the rounded values, f32
  accumulation, one rounding of ``o``;
* grouped_matmul: exact bf16 products and f32 sums in the kernel's order
  over d, one 16-step MMA after another.

It says whether the designs fit the tolerances before any card time; it
does not stand in for the card's comparison (``chip_smoke.py``,
``tests/test_torch_gpu.py``).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as j_gmm

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
#: keys per K/V tile of the tensor-core flash design (``tc::kBK``)
FLASH_KEY_TILE = 32
#: d-steps per tensor-core MMA of the grouped_matmul design
GMM_K_STEP = 16


def _bf16(rng, shape):
    """Seeded standard normals rounded to bf16: (torch bf16, numpy f32
    holding the same values)."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t = t.to(torch.bfloat16)
    return t, t.float().numpy()


def flash_emulation(q, k, v, causal):
    """The tensor-core flash design's arithmetic: q ``(B, Sq, H, hd)``, k
    and v ``(B, Skv, KV, hd)`` in bf16 -> ``(B, Sq, H, hd)`` bf16."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    s_all = (qf @ kf.transpose(-1, -2)) * hd ** -0.5
    if causal:
        keep = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
        s_all = s_all.masked_fill(~keep, float("-inf"))
    m = torch.full((b, h, sq), float("-inf"))
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, hd))
    for k0 in range(0, skv, FLASH_KEY_TILE):
        s = s_all[..., k0:k0 + FLASH_KEY_TILE]
        mx = torch.maximum(m, s.amax(-1))
        base = torch.where(mx == float("-inf"), torch.zeros_like(mx), mx)
        corr = torch.exp(m - base)
        p = torch.exp(s - base[..., None]).to(torch.bfloat16).float()
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vf[..., k0:k0 + FLASH_KEY_TILE, :]
        m = mx
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(torch.bfloat16).transpose(1, 2)


def gmm_emulation(x, w):
    """The tensor-core grouped_matmul design's arithmetic: x ``(E, C,
    d)``, w ``(E, d, f)`` in bf16 -> ``(E, C, f)`` bf16."""
    acc = torch.zeros((x.shape[0], x.shape[1], w.shape[2]))
    for k0 in range(0, x.shape[2], GMM_K_STEP):
        acc += (x[:, :, k0:k0 + GMM_K_STEP].float()
                @ w[:, k0:k0 + GMM_K_STEP, :].float())
    return acc.to(torch.bfloat16)


def _j_flash(q, k, v, causal):
    """The JAX oracle on the grouped-query layout (KV heads repeated,
    heads folded into the batch, as the reference op feeds its kernel)."""
    b, sq, h, hd = q.shape
    g = h // k.shape[2]
    fold = lambda a: jnp.asarray(np.repeat(a, h // a.shape[2], axis=2)
                                 .transpose(0, 2, 1, 3)
                                 .reshape(b * h, a.shape[1], hd),
                                 dtype=jnp.bfloat16)
    out = j_attention(fold(q), fold(k), fold(v), causal=causal)
    assert g * k.shape[2] == h
    return np.asarray(out.astype(jnp.float32)).reshape(b, h, sq, hd) \
        .transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,group", [(112, 8), (112, 10), (256, 8),
                                      (256, 10)])
def test_flash_tensorcore_rounding_meets_the_card_tolerance(hd, group,
                                                            causal):
    rng = np.random.default_rng(hd * 100 + group)
    b, s, kv = 2, 200, 2
    q, qn = _bf16(rng, (b, s, group * kv, hd))
    k, kn = _bf16(rng, (b, s, kv, hd))
    v, vn = _bf16(rng, (b, s, kv, hd))
    got = flash_emulation(q, k, v, causal).float().numpy()
    want = _j_flash(qn, kn, vn, causal)
    rtol, atol = CS.FLASH_TOL["bfloat16"]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", [s for s, dt in CS.GMM_SHAPES
                                   if dt == "bfloat16"
                                   and s not in CS.GMM_SERVE])
@pytest.mark.parametrize("d", [None, 7168])
def test_gmm_tensorcore_rounding_meets_the_card_tolerance(shape, d):
    e, c, d0, f = shape
    d = d or d0
    rng = np.random.default_rng(e * c + d)
    x, xn = _bf16(rng, (e, c, d))
    w, wn = _bf16(rng, (e, d, f))
    got = gmm_emulation(x, w).float().numpy()
    want = np.asarray(j_gmm(jnp.asarray(xn, dtype=jnp.bfloat16),
                            jnp.asarray(wn, dtype=jnp.bfloat16))
                      .astype(jnp.float32))
    rtol, atol = CS.GMM_TOL["bfloat16"]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
