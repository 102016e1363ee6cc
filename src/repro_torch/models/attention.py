"""Attention blocks of the port: grouped-query attention (GQA), the twin
of the GQA half of the reference's ``repro/models/attention.py``.

Prefill and training attention (``gqa_apply``) goes through the
``flash_attention`` op: the CUDA kernel on the card, its plain version on
the CPU; when a gradient is wanted, through its autograd op
(``FlashAttention``: the forward kernel with the row log-sum-exp, the
backward kernel).  For the
``attn`` layers that is the reference's ``blocked_attention(causal=True)``.
For the ``local`` layers the reference takes ``sliding_window_attention``;
for a prompt no longer than the window the window masks nothing and the
two are the same function, and a longer prompt raises
``NotImplementedError`` (windowed prefill is ROADMAP A9.1).
Decode (``gqa_decode``, with the ring buffer of the ``local`` layers) is
plain torch, as in the reference.  All softmax math in float32.

MLA, cross-attention and the reference's sharded paths (``_cp_attention``,
``_head_shard``) are not ported yet (ROADMAP A9.2, A9.3, A9.6).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L

Params = Dict[str, Any]
NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating each kv head G times."""
    kv = k.shape[2]
    if kv == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // kv, dim=2)


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token decode. q:(B,1,H,hd); caches:(B,S,H,hd); pos:(B,) current
    write position (keys at index <= pos are valid)."""
    s = k_cache.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * q.shape[-1] ** -0.5).float(),
                          k_cache.float())[:, :, 0]            # (B,H,S)
    mask = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    logits = torch.where(mask[:, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out[:, None].to(q.dtype)                             # (B,1,H,hd)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": L.dense_init(gen, d, h * hd, dtype, device),
         "wk": L.dense_init(gen, d, kv * hd, dtype, device),
         "wv": L.dense_init(gen, d, kv * hd, dtype, device),
         "wo": L.dense_init(gen, h * hd, d, dtype, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = L.full(gen, (n * hd,), 0.0, dtype, device)
    return p


def _qkv(cfg: ModelConfig, p: Params, x):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


def gqa_apply(cfg: ModelConfig, p: Params, x, positions, *, window: int = 0,
              kv_out: bool = False):
    """Full-sequence causal attention (prefill, training). Returns (out,
    (k, v)) with ``kv_out``, else (out, None).  With a ``window``, a
    prompt longer than it raises ``NotImplementedError``."""
    b, s = x.shape[:2]
    if window and s > window:
        raise NotImplementedError(
            f"a {s}-token prompt through a local-attention layer of window "
            f"{window}: the windowed flash-attention kernel is not ported "
            f"yet (ROADMAP A9.1); prompts of at most {window} tokens are "
            f"served")
    q, k, v = _qkv(cfg, p, x)
    if cfg.partial_rotary_factor > 0:
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    out = flash_attention(q, k, v, causal=True)
    out = out.reshape(b, s, -1) @ p["wo"]
    return (out, (k, v)) if kv_out else (out, None)


def gqa_decode(cfg: ModelConfig, p: Params, x, cache: Params, pos, *,
               window: int = 0):
    """One-token decode with KV cache. x:(B,1,d); pos:(B,). Returns
    (out, cache). Cache k/v: (B,S,KV,hd) (ring buffer of size W for
    sliding-window layers), written in place: the returned cache is the
    one given, with this token's K/V at its slot."""
    q, k, v = _qkv(cfg, p, x)
    if cfg.partial_rotary_factor > 0:
        q = L.apply_rope(q, pos[:, None], cfg.rope_theta, cfg.partial_rotary_factor)
        k = L.apply_rope(k, pos[:, None], cfg.rope_theta, cfg.partial_rotary_factor)
    k_cache, v_cache = cache["k"], cache["v"]
    s_cache = k_cache.shape[1]
    slot = (pos % s_cache if window else pos).long()
    rows = torch.arange(x.shape[0], device=x.device)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    ke = _expand_kv(k_cache, cfg.num_heads)
    ve = _expand_kv(v_cache, cfg.num_heads)
    if window:
        # ring buffer: entry at index i holds global position
        # floor((pos - i) / W) * W + i -> valid iff within window of pos.
        idx = torch.arange(s_cache, device=x.device)[None, :]
        age = (slot[:, None] - idx) % s_cache                  # 0..W-1 steps ago
        mask = age <= torch.clamp(pos, max=s_cache - 1)[:, None]
        logits = torch.einsum(
            "bqhd,bkhd->bhk", (q * cfg.resolved_head_dim ** -0.5).float(),
            ke.float())
        logits = torch.where(mask[:, None], logits, NEG_INF)
        pr = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhk,bkhd->bhd", pr.to(ve.dtype).float(),
                           ve.float())
        out = out[:, None].to(x.dtype)
    else:
        out = decode_attention(q, ke, ve, pos)
    b, s = x.shape[:2]
    out = out.reshape(b, s, -1) @ p["wo"]
    return out, {"k": k_cache, "v": v_cache}


def gqa_cache_init(cfg: ModelConfig, batch: int, seq: int, dtype,
                   device) -> Params:
    hd = cfg.resolved_head_dim
    shape = (batch, seq, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
