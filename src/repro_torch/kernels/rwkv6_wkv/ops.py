"""Public ops: the RWKV-6 WKV recurrence.

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel (``kernel.wkv_cuda``), CPU tensors take the plain
version (``ref.wkv_ref``).  There is no fallback from one to the other:
a CUDA launch that cannot run raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import aligned
from repro_torch.kernels.rwkv6_wkv.kernel import wkv_cuda
from repro_torch.kernels.rwkv6_wkv.ref import wkv_ref


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: ``(B, T, H, hd)``; u: ``(H, hd)``.  Returns (out
    ``(B, T, H, hd)``, final state ``(B, H, hd, hd)``), float32, the
    state starting at zero."""
    dev = r.device.type
    if dev == "cuda":
        return wkv_cuda(*(aligned(x.float()) for x in (r, k, v, w, u)))
    if dev == "cpu":
        return wkv_ref(r, k, v, w, u)
    raise ValueError(f"wkv runs on cuda or cpu tensors, not {dev}")


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The reference op's layout (``repro/kernels/rwkv6_wkv/ops.py``):
    r, k, v, w ``(BH, T, hd)``, u ``(BH, hd)`` -> out ``(BH, T, hd)``
    float32.  Each of the BH rows is one head of one batch: ``wkv`` on
    ``(1, T, BH, hd)``."""
    def view(x):
        return x.transpose(0, 1)[None]
    out, _ = wkv(view(r), view(k), view(v), view(w), u)
    return out[0].transpose(0, 1)
