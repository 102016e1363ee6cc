"""``csrc/flash_attention.cu`` at the shapes of the encoder-decoder and the
VLM slice, run on the CPU against the plain version.

The source is built with g++ against ``tests/cuda_cpu_mock.h``
(``test_torch_flash_bwd_cpu.mock_source``: the CUDA threads of a block as
fibers, ``mma.sync``, ``ldmatrix`` and ``cp.async`` emulated), both
designs: float32 on the CUDA cores, bfloat16 on the tensor cores.  Cases:

* head dim 96 (phi-3-vision-4.2b), new in this instance: causal and
  non-causal, GQA rows packed, ragged lengths (not a multiple of the
  32-key tile or of the 64- and 32-row query tiles).  At hd 96 each lane
  of the f32 design owns 3 output columns, the first odd count, so its
  loads and stores are scalar;
* whisper-large-v3's attention at hd 64, non-causal: the encoder's
  self-attention over 1 500 frames (46 full 32-key tiles and one of 28,
  masked by the ``key < Skv`` test alone), and the decoder's
  cross-attention, Sq decoder positions against Skv frames, Sq < Skv
  and Sq > Skv; B and H cut so that the mock stays fast;
* head dim 80 (stablelm-3b), causal with GQA and non-causal at Sq != Skv:
  4 columns a lane of the f32 design (lanes 20-31 own none), 10 chunks a
  row of the bf16 one.

Each within ``chip_smoke.FLASH_TOL``.  Skips without g++.
"""
import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import (DTYPES, HEAD_DIMS,
                                                        LSE_HEAD_DIMS)
from test_torch_flash_bwd_cpu import mock_source

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FLASH_TOL = _chip_smoke().FLASH_TOL

#: (b, sq, skv, h, kv, hd), causal
CASES = [((1, 100, 100, 4, 2, 96), True),
         ((1, 100, 100, 4, 2, 96), False),
         ((2, 70, 70, 2, 2, 96), True),
         ((1, 37, 130, 3, 1, 96), False),
         ((1, 64, 1500, 1, 1, 64), False),
         ((1, 40, 75, 2, 2, 64), False),
         ((1, 75, 40, 2, 2, 64), False),
         ((1, 90, 90, 4, 2, 80), True),
         ((1, 37, 60, 2, 1, 80), False)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("flash_hd96_mock")
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
    return out


def _inputs(b, sq, skv, h, kv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)
        for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", CASES,
                         ids=[f"{'x'.join(map(str, s))}-c{int(c)}"
                              for s, c in CASES])
def test_kernel_source_matches_plain(lib, shape, causal, dtype):
    b, sq, skv, h, kv, hd = shape
    q, k, v = _inputs(*shape, dtype, seed=sum(shape) + causal)
    o = torch.full((b, sq, h, hd), float("nan"), dtype=dtype)
    assert lib.flash_attention_window_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, skv,
        h, kv, hd, hd, int(causal), 0, hd ** -0.5, DTYPES[dtype], None) == 0
    want = flash_attention(q, k, v, causal=causal)
    rtol, atol = FLASH_TOL[str(dtype).split(".")[-1]]
    np.testing.assert_allclose(o.float().numpy(), want.float().numpy(),
                               rtol=rtol, atol=atol)


def test_head_dim_96_is_an_instance():
    assert (96, 96) in HEAD_DIMS and (96, 96) in LSE_HEAD_DIMS


def test_head_dim_80_is_an_instance():
    """stablelm-3b's head dim, in both designs (lanes 0-19 own 4 columns
    of the f32 design's output; 10 chunks a row in the bf16 one)."""
    assert (80, 80) in HEAD_DIMS and (80, 80) in LSE_HEAD_DIMS
