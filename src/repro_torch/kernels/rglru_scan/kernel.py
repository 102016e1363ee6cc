"""The CUDA ``rglru_scan`` kernel: bind and launch.

The source is ``repro_torch/csrc/rglru_scan.cu``, built and loaded by
``repro_torch.kernels._build`` (``nvcc`` at first use, cached by content
hash; nothing runs at import time).

``rglru_scan_cuda`` launches the kernel on PyTorch's current stream and
adds one to ``LAUNCHES["rglru_scan"]`` per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.library("rglru_scan").rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    """a, b ``(T, B, w)`` and h0 ``(B, w)``, float32 and contiguous, on
    one CUDA device -> h ``(T, B, w)`` float32.  Raises on anything the
    kernel does not take."""
    dev = a.device
    if dev.type != "cuda" or b.device != dev or h0.device != dev:
        raise ValueError(f"rglru_scan_cuda needs CUDA tensors on one device, "
                         f"got {a.device}, {b.device}, {h0.device}")
    if not all(t.dtype == torch.float32 for t in (a, b, h0)):
        raise ValueError(f"a, b, h0 must be float32, got {a.dtype}, "
                         f"{b.dtype}, {h0.dtype}")
    if a.dim() != 3 or b.shape != a.shape or tuple(h0.shape) != a.shape[1:]:
        raise ValueError(f"need a, b (T, B, w) and h0 (B, w), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    if not (a.is_contiguous() and b.is_contiguous() and h0.is_contiguous()):
        raise ValueError("a, b and h0 must be contiguous")
    t, bdim, w = a.shape
    if bdim * w < 1:
        raise ValueError(f"need B * w >= 1, got {bdim} * {w}")
    out = torch.empty_like(a)
    err = _launcher()(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                      out.data_ptr(), t, bdim * w,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["rglru_scan"] += 1
    return out
