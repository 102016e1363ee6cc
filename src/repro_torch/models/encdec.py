"""Whisper-style encoder-decoder of the port: the twin of the reference's
``repro/models/encdec.py``.

As in the reference, the conv/mel frontend is a stub: the encoder takes
precomputed frame embeddings ``(B, Se, d)`` (``Se = cfg.encoder.seq_len``,
1 500 for whisper-large-v3), and decoder positions are sinusoidal (real
whisper learns them: a documented deviation, FLOP-neutral) so that one
checkpoint serves any decoder length.

The reference stacks the encoder's layers (``enc_blocks``) and the
decoder's (``segments[0]["u0"]``) for ``lax.scan``; the port keeps one
parameter dict per layer, in order, under ``enc_layers`` and ``layers``
(``repro_torch.convert`` carries the one layout to the other).  Every
attention of the prefill goes through the ``flash_attention`` op: the
encoder's self-attention and the decoder's cross-attention non-causal
(Sq decoder queries against Se frames), the decoder's self-attention
causal, none of them rotary.  Decode is plain torch, as in the
reference: the self-attention by ``gqa_decode`` over the per-layer
cache, the cross-attention by ``decode_attention`` over the K/V of every
frame that prefill wrote once.  The cache is one ``{"self": {k, v},
"cross": {k, v}}`` per decoder layer; the logits are the tied
embedding's.

Training runs ``forward`` (the encoder, then the decoder over the whole
sequence), every attention through the op's gradient; with
``cfg.parallel.remat`` each encoder and decoder layer is recomputed in
the backward (``torch.utils.checkpoint``, non-reentrant), as the
reference's ``jax.checkpoint`` of its scan bodies.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import torch_dtype

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def enc_block_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    return {"norm1": L.layernorm_init(gen, cfg.d_model, dtype, device),
            "attn": A.cross_attn_init(gen, cfg, dtype, device),  # MHA layout
            "norm2": L.layernorm_init(gen, cfg.d_model, dtype, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dtype,
                              device)}


def dec_block_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    return {"norm1": L.layernorm_init(gen, cfg.d_model, dtype, device),
            "self_attn": A.gqa_init(gen, cfg, dtype, device),
            "norm_x": L.layernorm_init(gen, cfg.d_model, dtype, device),
            "cross_attn": A.cross_attn_init(gen, cfg, dtype, device),
            "norm2": L.layernorm_init(gen, cfg.d_model, dtype, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dtype,
                              device)}


def init_params(cfg: ModelConfig, gen: Optional[L.Draw], device) -> Params:
    """``{"pos_embed", "enc_norm", "embed", "final_norm", "enc_layers":
    [one dict per encoder layer], "layers": [one per decoder layer]}``,
    allocated (``gen`` None; constants filled) or drawn in place into
    ``gen``'s leaves, in this order.  ``pos_embed`` is drawn N(0, 0.01^2)
    as the reference draws it."""
    dtype = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    params: Params = {
        "pos_embed": L.normal(gen, (cfg.encoder.seq_len, d), 0.01, dtype,
                              device),
        "enc_norm": L.layernorm_init(gen, d, dtype, device),
        "embed": L.embed_init(gen, cfg.vocab_size, d, dtype, device),
        "final_norm": L.layernorm_init(gen, d, dtype, device)}
    params["enc_layers"] = [enc_block_init(gen, cfg, dtype, device)
                            for _ in range(cfg.encoder.num_layers)]
    params["layers"] = [dec_block_init(gen, cfg, dtype, device)
                        for _ in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _layers(body, cfg: ModelConfig, layer_params, x, *args,
            remat: bool = False):
    """``x = body(cfg, p, x, *args)`` for each layer's ``p`` in order, each
    recomputed in the backward when ``remat``."""
    for p in layer_params:
        x = checkpoint(body, cfg, p, x, *args, use_reentrant=False) \
            if remat else body(cfg, p, x, *args)
    return x


def _enc_block(cfg: ModelConfig, p: Params, x):
    """One encoder layer: LN, MHA non-causal over the frames, LN, MLP."""
    h = L.layernorm(p["norm1"], x, cfg.norm_eps)
    a, _ = A.cross_attn_apply(cfg, p["attn"], h, enc=h)  # self, MHA
    x = x + a
    h = L.layernorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, "gelu")


def encode(cfg: ModelConfig, params: Params, feats,
           remat: bool = False) -> torch.Tensor:
    """feats (B, Se, d) precomputed frame embeddings (the frontend stub)
    -> the encoder's output (B, Se, d) in the compute dtype; ``remat``
    recomputes each layer in the backward."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = feats.to(cdt) + params["pos_embed"].to(cdt)[None]
    x = _layers(_enc_block, cfg, params["enc_layers"], x, remat=remat)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder: the full-sequence forward and prefill
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: Params, tokens) -> torch.Tensor:
    """Token embeddings plus the sinusoidal rows of positions 0..S-1."""
    cdt = torch_dtype(cfg.compute_dtype)
    pos = L.sinusoidal_positions(tokens.shape[1], cfg.d_model, tokens.device)
    return F.embedding(tokens.long(), params["embed"]).to(cdt) + \
        pos.to(cdt)[None]


def _dec_block(cfg: ModelConfig, p: Params, x, enc, positions):
    """One decoder layer over the whole sequence.  Returns (x, self-attn
    (k, v), cross-attn (k, v))."""
    h = L.layernorm(p["norm1"], x, cfg.norm_eps)
    a, kv = A.gqa_apply(cfg, p["self_attn"], h, positions, causal=True,
                        rope=False, kv_out=True)
    x = x + a
    h = L.layernorm(p["norm_x"], x, cfg.norm_eps)
    a, ckv = A.cross_attn_apply(cfg, p["cross_attn"], h, enc=enc)
    x = x + a
    h = L.layernorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, "gelu"), kv, ckv


def _dec_train(cfg: ModelConfig, p: Params, x, enc, positions):
    """``_dec_block``'s new x alone (training keeps no cache)."""
    return _dec_block(cfg, p, x, enc, positions)[0]


def forward(cfg: ModelConfig, params: Params, tokens, encoder_feats):
    """tokens (B, S) decoder input, encoder_feats (B, Se, d) -> (hidden (B,
    S, d), aux 0), the training forward; with ``cfg.parallel.remat`` each
    encoder and decoder layer is recomputed in the backward."""
    remat = cfg.parallel.remat
    enc = encode(cfg, params, encoder_feats, remat=remat)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _layers(_dec_train, cfg, params["layers"], x, enc, positions,
                remat=remat)
    x = L.layernorm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Serving: prefill + decode with the self-attention cache and the
# precomputed cross-attention K/V
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device) -> List[Params]:
    """One ``{"self": {k, v} (B, seq, KV, hd), "cross": {k, v} (B, Se, H,
    hd)}`` per decoder layer, zeros in the compute dtype."""
    dtype = torch_dtype(cfg.compute_dtype)
    hd = cfg.resolved_head_dim
    se = cfg.encoder.seq_len

    def kv(shape):
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return [{"self": kv((batch, seq, cfg.num_kv_heads, hd)),
             "cross": kv((batch, se, cfg.num_heads, hd))}
            for _ in range(cfg.num_layers)]


def prefill(cfg: ModelConfig, params: Params, tokens, cache: List[Params],
            encoder_feats):
    """Encode the frames ``encoder_feats`` (B, Se, d), run the prompt
    ``tokens`` (B, S) through the decoder, fill the empty ``cache`` (of
    ``init_cache``): each layer's self-attention K/V at positions 0..S-1
    and its cross-attention K/V of every frame.  Returns (hidden (B, S,
    d), cache)."""
    enc = encode(cfg, params, encoder_feats)
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=tokens.device)
    for p, c in zip(params["layers"], cache):
        x, (k, v), (ck, cv) = _dec_block(cfg, p, x, enc, positions)
        c["self"]["k"][:, :s] = k.to(c["self"]["k"].dtype)
        c["self"]["v"][:, :s] = v.to(c["self"]["v"].dtype)
        c["cross"]["k"].copy_(ck)
        c["cross"]["v"].copy_(cv)
    x = L.layernorm(params["final_norm"], x, cfg.norm_eps)
    return x, cache


def decode_step(cfg: ModelConfig, params: Params, cache: List[Params],
                tokens, pos):
    """tokens (B, 1), pos (B,) -> (logits (B, 1, V) float32, cache, written
    in place).  The cross K/V must be prefilled."""
    cdt = torch_dtype(cfg.compute_dtype)
    b = tokens.shape[0]
    hd, nh = cfg.resolved_head_dim, cfg.num_heads
    x = F.embedding(tokens.long(), params["embed"]).to(cdt) + \
        L.sinusoidal(pos, cfg.d_model)[:, None].to(cdt)
    every_frame = torch.full((b,), cfg.encoder.seq_len - 1, dtype=torch.int32,
                             device=x.device)
    new_cache = []
    for p, c in zip(params["layers"], cache):
        h = L.layernorm(p["norm1"], x, cfg.norm_eps)
        a, self_c = A.gqa_decode(cfg, p["self_attn"], h, c["self"], pos,
                                 rope=False)
        x = x + a
        h = L.layernorm(p["norm_x"], x, cfg.norm_eps)
        q = (h @ p["cross_attn"]["wq"]).reshape(b, 1, nh, hd)
        a = A.decode_attention(q, c["cross"]["k"], c["cross"]["v"],
                               every_frame)
        x = x + a.reshape(b, 1, -1) @ p["cross_attn"]["wo"]
        h = L.layernorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(p["mlp"], h, "gelu")
        new_cache.append({"self": self_c, "cross": c["cross"]})
    x = L.layernorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ params["embed"].T.to(x.dtype)).float(), new_cache
