"""The CUDA ``grouped_matmul`` kernel: bind and launch.

The source is ``repro_torch/csrc/grouped_matmul.cu``, built and loaded
by ``repro_torch.kernels._build`` (``nvcc`` at first use, cached by
content hash; nothing runs at import time).

``grouped_matmul_cuda`` launches the kernel on PyTorch's current stream
and adds one to ``LAUNCHES["grouped_matmul"]`` per launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, _build

#: x/w/out dtypes the kernel takes, with its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.library("grouped_matmul").grouped_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``(E, C, d)`` and w ``(E, d, f)``, contiguous, on one CUDA
    device and on 16-byte boundaries, both float32 or both bfloat16, every
    dimension at least 1 and E at most 65 535 -> ``(E, C, f)`` in x's
    dtype.  Raises on anything the kernel does not take (checked before
    anything is built or launched)."""
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or both bfloat16, "
                         f"got {x.dtype}, {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"need x (E, C, d) and w (E, d, f), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    e, c, d = x.shape
    f = w.shape[2]
    if min(e, c, d, f) < 1 or e > 65535 or max(c, d, f) >= 1 << 31:
        raise ValueError(f"need every dimension >= 1, E <= 65535 and C, d, "
                         f"f < 2^31, got E {e}, C {c}, d {d}, f {f}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must start on 16-byte boundaries")
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"grouped_matmul_cuda needs CUDA tensors on one "
                         f"device, got {x.device}, {w.device}")
    out = torch.empty((e, c, f), dtype=x.dtype, device=dev)
    err = _launcher()(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                      DTYPES[x.dtype],
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["grouped_matmul"] += 1
    return out
