"""The CUDA ``colibri_scatter`` commit kernel: bind and launch.

The source is ``repro_torch/csrc/colibri_scatter.cu``, built and loaded
by ``repro_torch.kernels._build`` (``nvcc`` at first use, cached by
content hash; nothing runs at import time).

``scatter_commit_cuda`` launches the kernel on PyTorch's current stream
and adds one to ``LAUNCHES["colibri_scatter"]`` per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build

#: vals/out dtypes the kernel takes, with its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.library("colibri_scatter").colibri_commit_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scatter_commit_cuda(sorted_keys: torch.Tensor, sorted_vals: torch.Tensor,
                        num_bins: int) -> torch.Tensor:
    """Segmented commit of a key-sorted stream: keys ``(T,)`` int32
    sorted ascending, vals ``(T, d)`` float32 or bfloat16 ->
    ``(num_bins, d)`` in vals' dtype.  Keys outside ``[0, num_bins)``
    are dropped.  Raises on anything the kernel does not take."""
    keys, vals = sorted_keys, sorted_vals
    dev = keys.device
    if dev.type != "cuda" or vals.device != dev:
        raise ValueError(f"scatter_commit_cuda needs CUDA tensors on one "
                         f"device, got {keys.device} and {vals.device}")
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError(f"keys must be (T,) int32, got {keys.dtype}"
                         f"{tuple(keys.shape)}")
    if vals.dtype not in DTYPES or vals.dim() != 2:
        raise ValueError(f"vals must be (T, d) float32 or bfloat16, got "
                         f"{vals.dtype}{tuple(vals.shape)}")
    t, d = vals.shape
    if keys.shape[0] != t:
        raise ValueError(f"{keys.shape[0]} keys for {t} rows of vals")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and vals must be contiguous")
    if num_bins < 1 or d < 1:
        raise ValueError(f"need num_bins >= 1 and d >= 1 (got {num_bins}, "
                         f"{d})")
    out = torch.empty((num_bins, d), dtype=vals.dtype, device=dev)
    err = _launcher()(keys.data_ptr(), vals.data_ptr(), out.data_ptr(), t, d,
                      num_bins, DTYPES[vals.dtype],
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"colibri_scatter kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["colibri_scatter"] += 1
    return out
