"""Windowed prefill (the ``local`` layers past their window) and the flash
kernel's new instances, against the reference.

* The plain ``flash_attention`` with a ``window`` against the reference's
  ``sliding_window_attention`` (KV heads repeated, as its ``gqa_apply``
  feeds it), numpy-seeded, f32: rtol 2e-5 / atol 1e-4 (``tests/
  test_kernels.py``'s f32 tolerance; the two sum in other orders).
* ``recurrentgemma-2b-smoke`` (window 64) serving 160-token prompts
  through both engines: equal greedy tokens; and its decode across the
  ring buffer's wrap, step by step against the reference's decode (2e-3,
  as ``tests/test_torch_models.py`` holds the whole model).
* ``csrc/flash_attention.cu`` built with g++ against ``tests/
  cuda_cpu_mock.h`` (``test_torch_flash_bwd_cpu.mock_source``), both
  designs (f32 CUDA cores, bf16 tensor cores): windows of 50 and 64 (not
  multiples of the 32-key tile, and one that is), GQA, ragged lengths,
  and the 192/128 instance, each against the plain version within
  ``chip_smoke.FLASH_TOL``; ``window = 0`` and a window past the sequence
  give the causal kernel's bits.
"""
import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.distributed.sharding import Policy
from repro.models import attention as JA
from repro.models import build as j_build
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import model_from_jax, unstack_segments
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import DTYPES, HEAD_DIMS
from repro_torch.serving import Request, ServeEngine
from test_torch_flash_bwd_cpu import mock_source
from jax_cache import release_compiled  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NAME = "recurrentgemma-2b-smoke"
POL = Policy()
F32_TOL = dict(rtol=2e-5, atol=1e-4)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FLASH_TOL = _chip_smoke().FLASH_TOL


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _qkv(b, s, h, kv, hd, seed, hdv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hdv or hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# The plain version against sliding_window_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 150, 4, 2, 32, 50), (1, 200, 4, 1, 32, 64), (1, 40, 2, 2, 64, 64),
    (2, 97, 3, 1, 16, 1)])
def test_windowed_plain_version_matches_sliding_window_attention(
        b, s, h, kv, hd, window):
    q, k, v = _qkv(b, s, h, kv, hd, seed=s + window)
    rep = lambda a: jnp.asarray(np.repeat(a, h // kv, axis=2))  # noqa: E731
    want = JA.sliding_window_attention(jnp.asarray(q), rep(k), rep(v),
                                       window=window)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_plain_version_scores_long_bands_in_chunks():
    """Past ``Q_CHUNK`` query rows: the band is the same function as
    the causal mask cut to the window, here 1 300 rows in two chunks."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1300, 2, 1, 16, 3))
    band = flash_attention(q, k, v, causal=True, window=300)
    i = torch.arange(1300)
    keep = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < 300)
    s = torch.einsum("qhd,khd->hqk", q[0], k[0].expand(-1, 2, -1)) * 0.25
    p = torch.softmax(s.masked_fill(~keep, -1e30), -1)
    want = torch.einsum("hqk,khd->qhd", p, v[0].expand(-1, 2, -1))
    np.testing.assert_allclose(band[0].numpy(), want.numpy(), **F32_TOL)


def test_window_needs_causal_and_a_key_for_every_query():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 1, 16, 0))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_attention(q, k[:, :4], v[:, :4], causal=True, window=4)


# ---------------------------------------------------------------------------
# recurrentgemma-2b-smoke past its window
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg = j_get_config(NAME)
    jm = j_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(NAME)
    return cfg, jcfg, jm, params, model_from_jax(cfg, _np(params), "cpu")


def test_160_token_prompts_serve_the_reference_tokens(pair):
    cfg, jcfg, _, params, model = pair
    assert cfg.local_window == 64
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, size=(160,)).astype(np.int32)
               for _ in range(2)]
    outs = []
    for eng, req in ((JServeEngine(jcfg, params, batch_size=2,
                                   cache_len=176), JRequest),
                     (ServeEngine(cfg, model, batch_size=2, cache_len=176,
                                  device="cpu"), Request)):
        reqs = [req(prompt=p, max_new_tokens=8, id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        assert eng.run_once() == 2
        outs.append([r.result for r in reqs])
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_decode_across_the_ring_wrap_matches(pair):
    """A 100-token prompt leaves positions 36..99 in the 64-slot ring
    (slot = position % 64, so the fill already wraps); 40 decode steps
    write slots 36..63, then wrap to 0..11.  Each step's logits equal
    the reference's, and the ring's contents too."""
    cfg, _, jm, params, model = pair
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 140)).astype(np.int32)
    prompt = 100
    pre = {"tokens": jnp.asarray(toks[:, :prompt])}
    _, jc = jax.jit(lambda p, b: jm.prefill(p, b, 160, POL))(params, pre)
    _, tc = model.prefill(torch.from_numpy(toks[:, :prompt]), 160)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, POL))
    for t in range(prompt, 140):
        tok = toks[:, t: t + 1]
        pos = np.full((2,), t, np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for want, got in zip(unstack_segments(cfg, _np(jc)), tc):
        if "attn" in want:
            assert got["attn"]["k"].shape[1] == cfg.local_window
            for k in ("k", "v"):
                np.testing.assert_allclose(got["attn"][k].numpy(),
                                           want["attn"][k], **MODEL_TOL)


# ---------------------------------------------------------------------------
# The kernel's source under the CPU mock
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("flash_window_mock")
    cc, so = d / "flash_attention_mock.cc", d / "libflash_attention_mock.so"
    cc.write_text(mock_source("flash_attention"))
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                           "-o", str(so), str(cc)], capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    out.flash_attention_window_launch.argtypes = \
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    out.flash_attention_lse_launch.argtypes = \
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return out


def mock_flash(lib, q, k, v, causal, window):
    b, sq, h, hd = q.shape
    skv, kv, hdv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.full((b, sq, h, hdv), float("nan"), dtype=q.dtype)
    err = lib.flash_attention_window_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, skv,
        h, kv, hd, hdv, int(causal), window, hd ** -0.5, DTYPES[q.dtype],
        None)
    assert err == 0
    return o


def _inputs(shape, dtype, seed):
    b, s, h, kv, hd, hdv = shape
    return tuple(torch.from_numpy(a).to(dtype)
                 for a in _qkv(b, s, h, kv, hd, seed, hdv))


#: (b, s, h, kv, hd, hdv), causal, window: bands of 50 (inside a key tile)
#: and 64 (two tiles) with GQA rows packed and ragged ends, a band of 1
#: (each row sees only itself), and MLA's 192/128 causal and not
MOCK_CASES = [((1, 150, 4, 2, 32, 32), True, 50),
              ((1, 130, 2, 1, 64, 64), True, 64),
              ((2, 45, 3, 3, 32, 32), True, 1),
              ((1, 70, 2, 2, 192, 128), True, 0),
              ((1, 40, 2, 1, 192, 128), False, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", MOCK_CASES,
                         ids=[f"{'x'.join(map(str, s))}-w{w}-c{int(c)}"
                              for s, c, w in MOCK_CASES])
def test_kernel_source_matches_plain(lib, shape, causal, window, dtype):
    q, k, v = _inputs(shape, dtype, seed=sum(shape) + window)
    got = mock_flash(lib, q, k, v, causal, window)
    want = flash_attention(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == want.dtype
    rtol, atol = FLASH_TOL[str(dtype).split(".")[-1]]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_window_zero_and_past_the_sequence_give_the_causal_bits(lib, dtype):
    """window = 0, the training entry (``flash_attention_lse_launch`` at
    window 0) and a window longer than the sequence run the same tiles:
    the same bits."""
    q, k, v = _inputs((1, 100, 4, 2, 32, 32), dtype, seed=5)
    causal = mock_flash(lib, q, k, v, True, 0)
    old = torch.full_like(q, float("nan"))
    assert lib.flash_attention_lse_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), old.data_ptr(), None, 1,
        100, 100, 4, 2, 32, 1, 0, 32 ** -0.5, DTYPES[dtype], None) == 0
    assert torch.equal(old, causal)
    for window in (100, 4096):
        assert torch.equal(mock_flash(lib, q, k, v, True, window), causal)


def test_kernel_refuses_what_it_does_not_take(lib):
    q, k, v = _inputs((1, 8, 2, 1, 32, 32), torch.float32, seed=0)
    fn = lib.flash_attention_window_launch
    o = torch.empty_like(q)

    def call(hd=32, hdv=32, causal=1, window=0, skv=8):
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                  8, skv, 2, 1, hd, hdv, causal, window, 1.0, 0, None)
    assert call() == 0
    assert call(hdv=16) != 0                   # no (32, 16) instance
    assert call(hd=128, hdv=64) != 0
    assert call(window=4, causal=0) != 0       # a band is causal
    assert call(window=4, skv=4) != 0          # Sq > Skv: rows see no key
    assert call(window=-1) != 0
    assert (192, 128) in HEAD_DIMS
