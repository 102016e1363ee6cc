"""Plain PyTorch version of flash attention: naive O(S^2) softmax
attention, as the reference's oracle (``repro/kernels/flash_attention/
ref.py``) computes it.

``flash_attention_ref`` feeds it the grouped-query layout as the
reference op (``repro/kernels/flash_attention/ops.py``) feeds its kernel:
KV heads repeated to the query heads, heads folded into the batch.  It
is what the CPU path runs and what the CUDA kernel is held against on
the card.  Scores and softmax in float32, output in q's dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: ``(BH, Sq, hd)``; k, v: ``(BH, Skv, hd)`` -> ``(BH, Sq, hd)``."""
    hd = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: ``(B, Sq, H, hd)``; k, v: ``(B, Skv, KV, hd)`` with
    ``H % KV == 0`` -> ``(B, Sq, H, hd)`` in q's dtype."""
    b, sq, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, sq, hd)
    kf = k.transpose(1, 2).reshape(b * h, -1, hd)
    vf = v.transpose(1, 2).reshape(b * h, -1, hd)
    out = attention_ref(qf, kf, vf, causal=causal)
    return out.reshape(b, h, sq, hd).transpose(1, 2)
