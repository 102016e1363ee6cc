"""Public op: the RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t``.

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel (``kernel.rglru_scan_cuda``), CPU tensors take the
plain version (``ref.rglru_scan_ref``).  There is no fallback from one
to the other: a CUDA launch that cannot run raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """a, b: ``(T, B, w)``; h0: ``(B, w)``.  Returns h ``(T, B, w)``
    float32."""
    dev = a.device.type
    if dev == "cuda":
        return rglru_scan_cuda(a.float().contiguous(), b.float().contiguous(),
                               h0.float().contiguous())
    if dev == "cpu":
        return rglru_scan_ref(a, b, h0)
    raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not {dev}")
