"""Public op: the RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t``.

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel (``kernel.rglru_scan_cuda``), CPU tensors take the
plain version (``ref.rglru_scan_ref``).  There is no fallback from one
to the other: a CUDA launch that cannot run raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_cuda,
                                                   unit_along_w)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """a, b: ``(T, B, w)``; h0: ``(B, w)``.  Returns h ``(T, B, w)``
    float32; on the card with a's strides, so the ``(T, B, w)`` view of a
    contiguous ``(B, T, w)`` tensor gets the same view back, and no
    copy is made of inputs whose last axis has unit stride."""
    dev = a.device.type
    if dev == "cuda":
        # the kernel reads any strides along T and B
        return rglru_scan_cuda(*(x if unit_along_w(x) else x.contiguous()
                                 for x in (y.float() for y in (a, b, h0))))
    if dev == "cpu":
        return rglru_scan_ref(a, b, h0)
    raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not {dev}")
