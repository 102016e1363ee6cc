"""The CUDA ``rwkv6_wkv`` kernel: bind and launch.

The source is ``repro_torch/csrc/rwkv6_wkv.cu``, built and loaded by
``repro_torch.kernels._build`` (``nvcc`` at first use, cached by content
hash; nothing runs at import time).

``wkv_cuda`` launches the kernel on PyTorch's current stream and adds
one to ``LAUNCHES["rwkv6_wkv"]`` per launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, _build

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.library("rwkv6_wkv").rwkv6_wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _axis_strides(x: torch.Tensor) -> Tuple[int, ...]:
    """``x``'s strides, 0 along axes of size 1 (never stepped along)."""
    return tuple(s if n > 1 else 0 for n, s in zip(x.shape, x.stride()))


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w ``(B, T, H, hd)`` float32 with one set of strides, unit
    stride along hd, the others multiples of 4; u ``(H, hd)`` float32
    contiguous; all on one CUDA device and on 16-byte boundaries; hd in
    ``HEAD_DIMS`` -> (out ``(B, T, H, hd)``, final state ``(B, H, hd,
    hd)``), float32 and contiguous.  Raises on anything the kernel does
    not take."""
    dev = r.device
    ins = (r, k, v, w, u)
    if dev.type != "cuda" or any(x.device != dev for x in ins):
        raise ValueError(f"wkv_cuda needs CUDA tensors on one device, got "
                         f"{[str(x.device) for x in ins]}")
    if any(x.dtype != torch.float32 for x in ins):
        raise ValueError(f"r, k, v, w, u must be float32, got "
                         f"{[x.dtype for x in ins]}")
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"need r, k, v, w of one (B, T, H, hd) shape, got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    b, t, h, hd = r.shape
    if tuple(u.shape) != (h, hd) or not u.is_contiguous():
        raise ValueError(f"need u contiguous ({h}, {hd}), got "
                         f"{tuple(u.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(b, t, h) < 1:
        raise ValueError(f"need B, T, H >= 1, got {b}, {t}, {h}")
    strides = _axis_strides(r)
    if any(_axis_strides(x) != strides for x in (k, v, w)) or strides[3] != 1 \
            or any(s % 4 for s in strides[:3]):
        raise ValueError(f"r, k, v, w need one set of strides, unit along "
                         f"hd and multiples of 4 elsewhere, got "
                         f"{[_axis_strides(x) for x in (r, k, v, w)]}")
    if any(x.data_ptr() % 16 for x in ins):
        raise ValueError("r, k, v, w and u must start on 16-byte boundaries")
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=dev)
    state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), out.data_ptr(), state.data_ptr(), b, t,
                      h, hd, strides[0], strides[1], strides[2],
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["rwkv6_wkv"] += 1
    return out, state
