"""Plain PyTorch version of the RG-LRU scan: the recurrence walked in
order, ``h_t = a_t * h_{t-1} + b_t``, in float32.

It is what the CPU path runs and what the CUDA kernel is held against on
the card.  The reference's oracle (``repro/kernels/rglru_scan/ref.py``)
takes an associative scan instead; the two sum in different orders and
agree to ``tests/test_kernels.py``'s 1e-4.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """a, b: ``(T, B, w)``; h0: ``(B, w)`` -> h ``(T, B, w)`` float32."""
    a, b = a.float(), b.float()
    h = h0.float()
    out = torch.empty_like(a)
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        out[t] = h
    return out
