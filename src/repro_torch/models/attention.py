"""Attention blocks of the port: grouped-query attention (GQA),
DeepSeek's multi-head latent attention (MLA) and whisper's cross-attention,
the twins of those parts of the reference's ``repro/models/attention.py``.

Prefill and training attention (``gqa_apply``, ``mla_apply``) goes
through the ``flash_attention`` op: the CUDA kernel on the card, its
plain version on the CPU; when a gradient is wanted, through its autograd
op (``FlashAttention``: the forward kernel with the row log-sum-exp, the
backward kernel).  For the ``attn`` layers that is the reference's
``blocked_attention(causal=True)``; for the ``local`` layers its
``sliding_window_attention``, the op with ``window=cfg.local_window``
(a prompt of any length); for MLA, ``blocked_attention`` over q/k of
``qk_nope + qk_rope`` (192) columns and v of ``v_head_dim`` (128), which
the kernel takes as they are where the reference pads v to 192; for
whisper's decoder, ``gqa_apply(rope=False)`` and ``cross_attn_apply``,
the op with ``causal=False`` over Sq decoder queries and Skv encoder
frames (``blocked_attention(causal=False)`` in the reference).
Decode (``gqa_decode``, with the ring buffer of the ``local`` layers;
``mla_decode``, absorbed into the latent space; whisper's cross-attention
over its prefilled K/V by ``decode_attention``) is plain torch, as in
the reference.  All softmax math in float32.

The reference's sharded paths (``_cp_attention``, ``_head_shard``) are
not ported yet (ROADMAP A9.6).
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


def gqa_apply(cfg: ModelConfig, p: Params, x, positions, *,
              causal: bool = True, window: int = 0, rope: bool = True,
              kv_out: bool = False):
    """Full-sequence attention (prefill, training), causal unless asked
    otherwise, banded to the last ``window`` positions when one is given,
    rotary unless ``rope`` is off. Returns (out, (k, v)) with ``kv_out``,
    else (out, None)."""
    b, s = x.shape[:2]
    q, k, v = _qkv(cfg, p, x)
    if rope and cfg.partial_rotary_factor > 0:
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    out = flash_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(b, s, -1) @ p["wo"]
    return (out, (k, v)) if kv_out else (out, None)


def gqa_decode(cfg: ModelConfig, p: Params, x, cache: Params, pos, *,
               window: int = 0, rope: bool = True):
    """One-token decode with KV cache. x:(B,1,d); pos:(B,). Returns
    (out, cache). Cache k/v: (B,S,KV,hd) (ring buffer of size W for
    sliding-window layers), written in place: the returned cache is the
    one given, with this token's K/V at its slot."""
    q, k, v = _qkv(cfg, p, x)
    if rope and cfg.partial_rotary_factor > 0:
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


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    """MHA projections without bias: ``wq``, ``wk``, ``wv`` (d, H * hd)
    and ``wo`` (H * hd, d)."""
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    return {"wq": L.dense_init(gen, d, h * hd, dtype, device),
            "wk": L.dense_init(gen, d, h * hd, dtype, device),
            "wv": L.dense_init(gen, d, h * hd, dtype, device),
            "wo": L.dense_init(gen, h * hd, d, dtype, device)}


def cross_attn_apply(cfg: ModelConfig, p: Params, x, enc_kv=None, enc=None):
    """x (B, S, d) attends to every encoder frame, non-causal: K/V from
    ``enc`` (B, Se, d), or the precomputed ``enc_kv`` = (k, v), each (B,
    Se, H, hd).  Returns (out (B, S, d), (k, v))."""
    b, s, _ = x.shape
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    if enc_kv is None:
        se = enc.shape[1]
        k = (enc @ p["wk"]).reshape(b, se, h, hd)
        v = (enc @ p["wv"]).reshape(b, se, h, hd)
    else:
        k, v = enc_kv
    out = flash_attention(q, k, v, causal=False)
    return out.reshape(b, s, -1) @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    r = m.kv_lora_rank
    return {
        "w_dq": L.dense_init(gen, d, m.q_lora_rank, dtype, device),
        "q_norm": L.rmsnorm_init(gen, m.q_lora_rank, dtype, device),
        "w_uq": L.dense_init(gen, m.q_lora_rank, h * qk_head, dtype, device),
        "w_dkv": L.dense_init(gen, d, r, dtype, device),
        "kv_norm": L.rmsnorm_init(gen, r, dtype, device),
        "w_kr": L.dense_init(gen, d, m.qk_rope_head_dim, dtype, device),
        # up-projections stored per head for the absorbed decode path
        "w_uk": L.normal(gen, (h, m.qk_nope_head_dim, r), r ** -0.5, dtype,
                         device),
        "w_uv": L.normal(gen, (h, r, m.v_head_dim), r ** -0.5, dtype, device),
        "wo": L.dense_init(gen, h * m.v_head_dim, d, dtype, device),
    }


def _mla_q(cfg: ModelConfig, p: Params, x, positions):
    m = cfg.mla
    b, s, _ = x.shape
    cq = L.rmsnorm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(b, s, cfg.num_heads,
                                 m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(cfg: ModelConfig, p: Params, x, positions):
    """The cached latents: c_kv ``(B, S, kv_lora_rank)`` and the shared
    rotary key ``(B, S, 1, qk_rope_head_dim)``."""
    c_kv = L.rmsnorm(p["kv_norm"], x @ p["w_dkv"], cfg.norm_eps)
    k_rope = L.apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                          cfg.rope_theta)
    return c_kv, k_rope


def mla_apply(cfg: ModelConfig, p: Params, x, positions):
    """Full-sequence MLA (prefill).  Returns (out, (c_kv, k_rope)).  k is
    materialised per head at ``qk_nope + qk_rope`` columns as in the
    reference; v keeps its ``v_head_dim`` (the kernel's 192/128
    instance), scale ``(qk_nope + qk_rope) ** -0.5``."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,hdr->bshd", c_kv, p["w_uk"])
    v = torch.einsum("bsr,hrv->bshv", c_kv, p["w_uv"])
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    out = flash_attention(q, k, v, causal=True)
    out = out.reshape(b, s, -1) @ p["wo"]
    return out, (c_kv, k_rope[:, :, 0])


def mla_decode(cfg: ModelConfig, p: Params, x, cache: Params, pos):
    """Absorbed-matrix decode: attention runs in the latent space; the
    cache holds only (c_kv, k_rope), written in place at ``pos``.  Plain
    torch; bf16 operands enter each product exactly and sum in float32
    (the reference's ``preferred_element_type``), rounded to the cache's
    dtype where the reference rounds."""
    m = cfg.mla
    b = x.shape[0]
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])
    c_new, kr_new = _mla_latent(cfg, p, x, pos[:, None])
    ckv, krope = cache["c_kv"], cache["k_rope"]
    rows = torch.arange(b, device=x.device)
    slot = pos.long()
    ckv[rows, slot] = c_new[:, 0].to(ckv.dtype)
    krope[rows, slot] = kr_new[:, 0, 0].to(krope.dtype)
    q_lat = torch.einsum("bqhd,hdr->bhr", q_nope.float(),
                         p["w_uk"].float())                       # (B,H,r)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s_lat = torch.einsum("bhr,bsr->bhs", q_lat.to(ckv.dtype).float(),
                         ckv.float())
    s_rope = torch.einsum("bqhd,bsd->bhs", q_rope.float(), krope.float())
    logits = (s_lat + s_rope) * scale
    idx = torch.arange(ckv.shape[1], device=x.device)[None, :]
    logits = torch.where((idx <= pos[:, None])[:, None], logits, NEG_INF)
    pr = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pr.to(ckv.dtype).float(),
                       ckv.float())                               # (B,H,r)
    out = torch.einsum("bhr,hrv->bhv", ctx.to(p["w_uv"].dtype).float(),
                       p["w_uv"].float())
    out = out.reshape(b, 1, -1).to(x.dtype) @ p["wo"]
    return out, {"c_kv": ckv, "k_rope": krope}


def mla_cache_init(cfg: ModelConfig, batch: int, seq: int, dtype,
                   device) -> Params:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, seq, m.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, seq, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
