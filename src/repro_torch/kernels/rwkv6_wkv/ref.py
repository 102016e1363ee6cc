"""Plain PyTorch version of the RWKV-6 WKV: the exact recurrence walked
in order, as the reference's model (``repro/models/rwkv6.py::_wkv_scan``)
and its oracle (``repro/kernels/rwkv6_wkv/ref.py::wkv_ref``) compute it,
in float32:

    out_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ,        S_{-1} = 0

per (batch, head), with S of ``(hd, hd)``.  It is what the CPU path runs
and what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: ``(B, T, H, hd)``; u: ``(H, hd)``.  Returns (out
    ``(B, T, H, hd)``, final state ``(B, H, hd, hd)``), float32."""
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    b, t, h, hd = r.shape
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    uc = u[None, :, :, None]
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]       # (B,H,hd,hd)
        out[:, i] = torch.einsum("bhk,bhkv->bhv", r[:, i], s + uc * kv)
        s = w[:, i, :, :, None] * s + kv
    return out, s
