"""Plain PyTorch version of flash attention: naive O(S^2) softmax
attention, as the reference's oracle (``repro/kernels/flash_attention/
ref.py``) computes it.

``flash_attention_ref`` feeds it the grouped-query layout as the
reference op (``repro/kernels/flash_attention/ops.py``) feeds its kernel:
KV heads repeated to the query heads, heads folded into the batch.  It
is what the CPU path runs and what the CUDA kernel is held against on
the card.  Scores and softmax in float32, output in q's dtype.  It also
takes what the kernel takes beyond the reference op: a ``window`` (key j
is visible to query i iff ``j <= i`` and ``i - j < window``, the mask of
the reference's ``sliding_window_attention``) and a v head dim below
q's and k's (MLA's 192/128).  It scores ``Q_CHUNK`` query rows at a time
against only the keys they can see, so a long band never materialises
S x S.

``flash_attention_fwd_lse_ref`` adds each query row's log-sum-exp, and
``flash_attention_bwd_ref`` is the gradient as the backward kernel
(``csrc/flash_attention_bwd.cu``) computes it: P recomputed from the
scores and that log-sum-exp, D = rowsum(dO o O), dS = P o (dO V^T - D),
all in float32 (float64 for float64 inputs), the group's query heads summed into their KV head.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or float64 if it is (the gradient check's)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


#: query rows the plain version scores at once
Q_CHUNK = 1024


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: ``(BH, Sq, hd)``; k: ``(BH, Skv, hd)``; v: ``(BH, Skv, hdv)`` ->
    ``(BH, Sq, hdv)``.  A ``window`` (> 0) needs ``causal``."""
    if window and not causal:
        raise ValueError("a window is a causal band: pass causal=True")
    hd = q.shape[-1]
    sq, skv = q.shape[1], k.shape[1]
    kw, vw = _wide(k), _wide(v)
    out = torch.empty(q.shape[:2] + v.shape[2:], dtype=q.dtype,
                      device=q.device)
    for q0 in range(0, sq, Q_CHUNK):
        q1 = min(q0 + Q_CHUNK, sq)
        k0 = max(0, q0 - window + 1) if window else 0
        k1 = min(skv, q1) if causal else skv
        s = torch.einsum("bqd,bkd->bqk", _wide(q[:, q0:q1]),
                         kw[:, k0:k1]) * hd ** -0.5
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)[:, None]
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            mask = qpos >= kpos
            if window:
                mask &= qpos - kpos < window
            s = torch.where(mask[None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out[:, q0:q1] = torch.einsum("bqk,bkd->bqd", p, vw[:, k0:k1])
    return out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: ``(B, Sq, H, hd)``; k: ``(B, Skv, KV, hd)``; v: ``(B, Skv, KV,
    hdv)`` with ``H % KV == 0`` -> ``(B, Sq, H, hdv)`` in q's dtype."""
    b, sq, h, hd = q.shape
    hdv = v.shape[-1]
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, sq, hd)
    kf = k.transpose(1, 2).reshape(b * h, -1, hd)
    vf = v.transpose(1, 2).reshape(b * h, -1, hdv)
    out = attention_ref(qf, kf, vf, causal=causal, window=window)
    return out.reshape(b, h, sq, hdv).transpose(1, 2)


def _heads_first(q, k, v):
    """q ``(B, Sq, H, hd)``, k/v ``(B, Skv, KV, hd)`` -> float32 ``(B, H,
    S, hd)`` each, KV heads repeated to the query heads."""
    g = q.shape[2] // k.shape[2]
    return (_wide(q).transpose(1, 2),
            _wide(k).repeat_interleave(g, dim=2).transpose(1, 2),
            _wide(v).repeat_interleave(g, dim=2).transpose(1, 2))


def _scaled_scores(qh, kh, causal: bool, window: int = 0):
    """scale * q k^T ``(B, H, Sq, Skv)`` and the mask of the keys each
    query sees (None when it sees all)."""
    if window and not causal:
        raise ValueError("a window is a causal band: pass causal=True")
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * qh.shape[-1] ** -0.5
    if not causal:
        return s, None
    sq, skv = qh.shape[2], kh.shape[2]
    gap = (torch.arange(sq, device=qh.device)[:, None]
           - torch.arange(skv, device=qh.device)[None, :])
    mask = gap >= 0
    if window:
        mask &= gap < window
    return s, mask


def flash_attention_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: int = 0):
    """``(flash_attention_ref(q, k, v), lse)``: lse float32 ``(B, H, Sq)``,
    the natural-log log-sum-exp of each row's scaled, masked scores
    (``window`` as ``flash_attention_ref``'s)."""
    s, mask = _scaled_scores(*_heads_first(q, k, v)[:2], causal, window)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    return flash_attention_ref(q, k, v, causal=causal, window=window), \
        torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True, window: int = 0):
    """``(dq, dk, dv)`` in the dtypes and shapes of q, k, v: the gradient
    of ``flash_attention_ref`` (with its ``window``) at output gradient
    ``do``, recomputed from the forward's output ``o`` and ``lse``
    (float32 ``(B, H, Sq)``)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qh, kh, vh = _heads_first(q, k, v)
    doh, oh = _wide(do).transpose(1, 2), _wide(o).transpose(1, 2)
    s, mask = _scaled_scores(qh, kh, causal, window)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    delta = (doh * oh).sum(-1)                                 # (B, H, Sq)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doh)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", doh, vh) - delta[..., None])
    scale = hd ** -0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale

    def per_kv_head(t):            # (B, H, Skv, hd) -> (B, Skv, KV, hd)
        return t.reshape(b, kv, h // kv, -1, hd).sum(2).transpose(1, 2)
    return (dq.transpose(1, 2).to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))
