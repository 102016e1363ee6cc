"""Plain PyTorch version of the RG-LRU scan: the recurrence walked in
order, ``h_t = a_t * h_{t-1} + b_t``, in float32.

It is what the CPU path runs and what the CUDA kernel is held against on
the card; ``rglru_scan_bwd_ref`` is its gradient, the adjoint recurrence
walked backwards.  The reference's oracle (``repro/kernels/rglru_scan/ref.py``)
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


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                       dh: torch.Tensor):
    """The gradient of ``h = rglru_scan_ref(a, b, h0)`` at ``dh``: ``(da,
    db, dh0)`` float32.  ``g = db`` walks ``g_t = dh_t + a_{t+1} g_{t+1}``
    from ``g_{T-1} = dh_{T-1}`` down; ``da_t = g_t h_{t-1}`` (h_{-1} =
    h0), ``dh0 = a_0 g_0``."""
    a, dh = a.float(), dh.float()
    g = torch.empty_like(dh)
    nxt = torch.zeros_like(dh[0])
    for t in range(a.shape[0] - 1, -1, -1):
        nxt = dh[t] + (a[t + 1] * nxt if t + 1 < a.shape[0] else 0.0)
        g[t] = nxt
    h_prev = torch.cat([h0[None].float(), h[:-1].float()], dim=0)
    return g * h_prev, g, a[0] * g[0]
