"""The CUDA ``flash_attention`` kernel: bind and launch.

The source is ``repro_torch/csrc/flash_attention.cu``, built and loaded
by ``repro_torch.kernels._build`` (``nvcc`` at first use, cached by
content hash; nothing runs at import time).

``flash_attention_cuda`` launches the kernel on PyTorch's current stream
and adds one to ``LAUNCHES["flash_attention"]`` per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build

#: q/k/v/o dtypes the kernel takes, with its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 112, 128, 256)


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q ``(B, Sq, H, hd)``, k and v ``(B, Skv, KV, hd)``, contiguous and
    on 16-byte boundaries, all float32 or all bfloat16, ``H % KV == 0``,
    hd in ``HEAD_DIMS`` -> ``(B, Sq, H, hd)`` in q's dtype.  Query head h
    reads KV head ``h // (H // KV)``.  Raises on anything the kernel does
    not take."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, H, hd) and k, v (B, Skv, KV, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, head dim, H % KV == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(b, sq, skv) < 1 or b * kv > 65535:
        raise ValueError(f"need B, Sq, Skv >= 1 and B * KV <= 65535, got "
                         f"{b}, {sq}, {skv}, {b * kv}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    out = torch.empty_like(q)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, sq, skv, h, kv, hd, int(causal),
                      hd ** -0.5, DTYPES[q.dtype],
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
