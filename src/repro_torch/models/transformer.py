"""Decoder-only LM assembly of the port: the twin of the reference's
``repro/models/transformer.py``, serving and (dense family) training.

The reference groups layers into *segments* (maximal runs of the
repeating block-pattern unit) and stacks each segment's params along a
leading axis for ``lax.scan``.  PyTorch runs eagerly, so the port keeps
one parameter dict per layer, in layer order (``params["layers"]``), and
walks them in a Python loop; ``plan_segments`` stays for the conversion
of stacked reference params (``repro_torch.convert.model_from_jax``).
Each layer's params live in a ``Block`` module; ``model_zoo.Model`` owns
the blocks in an ``nn.ModuleList``.

Ported: the dense (``attn``, GQA or MLA), ``local`` and ``rglru``
layers with their MLPs, the ``rwkv`` time-mix with its ``rwkv_cm``
channel-mix, the MoE models' FFNs (``dense`` for the leading layers,
``moe``: routed experts plus the shared expert), ``prefill`` and
``decode_step``, and the VLM frontend: ``prefill`` and ``forward``
splice precomputed patch embeddings over the first positions
(``patch_embeds``).  The encoder-decoder is ``repro_torch.models.
encdec``.

Training (``apply_block``, ``forward``, ``loss_fn``) takes the layers
whose kernels have a backward: GQA ``attn`` and ``local`` mixers (the
flash op's gradient, banded for ``local``) and ``rglru`` ones (the scan's
gradient), with dense MLPs; the VLM's spliced patches and the
encoder-decoder (``encdec.forward``) too.  ``check_trainable`` refuses
the rest (rwkv, MoE, MLA), naming the ROADMAP item that brings it.
``cfg.parallel.remat`` recomputes each
layer in the backward (``torch.utils.checkpoint``, non-reentrant), as the
reference's ``jax.checkpoint`` of its scan body; ``loss_fn`` recomputes
each 1 024-token chunk's logits, so the (B, S, V) float32 logits are
never held.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW

Params = Dict[str, Any]
LayerSig = Tuple[str, str]          # (mix_kind, ffn_kind)


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch
    dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Layer planning
# ---------------------------------------------------------------------------

def layer_sigs(cfg: ModelConfig) -> List[LayerSig]:
    sigs = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "rwkv":
            ffn = "rwkv_cm"
        elif cfg.moe is not None:
            ffn = "moe" if i >= cfg.moe.moe_layer_start else "dense"
        else:
            ffn = "mlp"
        sigs.append((kind, ffn))
    return sigs


def plan_segments(cfg: ModelConfig) -> List[Tuple[Tuple[LayerSig, ...], int]]:
    """[(unit, repeats), ...] — maximal cyclic runs (the reference's
    stacking of layer params)."""
    sigs = layer_sigs(cfg)
    p = len(cfg.block_pattern)
    segs: List[Tuple[Tuple[LayerSig, ...], int]] = []
    i, n = 0, len(sigs)
    while i < n:
        if p > 1 and n - i >= p:
            unit = tuple(sigs[i: i + p])
            k = 1
            while i + (k + 1) * p <= n and tuple(sigs[i + k * p: i + (k + 1) * p]) == unit:
                k += 1
            if k > 1:
                segs.append((unit, k))
                i += k * p
                continue
        j = i
        while j < n and sigs[j] == sigs[i]:
            j += 1
        segs.append(((sigs[i],), j - i))
        i = j
    return segs


def mlp_kind(cfg: ModelConfig) -> str:
    if cfg.act == "silu":
        return "swiglu"
    return "geglu" if cfg.norm == "rmsnorm" else "gelu"


def check_layers_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is an
    ``attn``, ``local`` or ``rglru`` mixer with a dense MLP (the layers
    ``forward`` runs and whose kernels have a backward), naming the
    ROADMAP item that brings the rest."""
    kinds = set(cfg.layer_kinds())
    missing = []
    if cfg.attn_kind == "mla":
        missing.append("MLA attention (a flash-attention backward at q/k "
                       "192, v 128, ROADMAP A9.8e)")
    if "rwkv" in kinds:
        missing.append("rwkv layers (an rwkv6_wkv backward kernel, ROADMAP "
                       "A9.8c)")
    if cfg.moe is not None:
        missing.append("MoE FFNs (a grouped_matmul backward kernel, ROADMAP "
                       "A9.8d)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: training {', '.join(missing)} is not ported yet; "
            f"the port trains attn, local and rglru layers with dense MLPs, "
            f"the encoder-decoder and the VLM")


def check_trainable(cfg: ModelConfig) -> None:
    """What ``Model.train_mode`` checks: the encoder-decoder's layers are
    GQA attention with dense MLPs, which train; every other architecture
    trains where ``check_layers_trainable`` lets it."""
    if cfg.encoder is None:
        check_layers_trainable(cfg)


# ---------------------------------------------------------------------------
# Per-block init / apply
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ModelConfig, sig: LayerSig, dtype, device) -> Params:
    mix, ffn = sig
    p: Params = {"norm1": L.norm_init(gen, cfg.norm, cfg.d_model, dtype,
                                      device),
                 "norm2": L.norm_init(gen, cfg.norm, cfg.d_model, dtype,
                                      device)}
    if mix == "attn" and cfg.attn_kind == "mla":
        p["attn"] = A.mla_init(gen, cfg, dtype, device)
    elif mix in ("attn", "local"):
        p["attn"] = A.gqa_init(gen, cfg, dtype, device)
    elif mix == "rglru":
        p["rglru"] = RG.rglru_init(gen, cfg, dtype, device)
    else:
        p["rwkv"] = RW.time_mix_init(gen, cfg, dtype, device)
    if ffn == "rwkv_cm":
        p["cm"] = RW.channel_mix_init(gen, cfg, dtype, device)
    elif ffn == "dense":
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.moe.dense_d_ff, "silu",
                              dtype, device)
    elif ffn == "moe":
        p["moe"] = MoE.moe_init(gen, cfg, dtype, device)
        p["shared"] = MoE.shared_init(gen, cfg, dtype, device)
    else:
        act = "gelu" if mlp_kind(cfg) == "gelu" else "silu"
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, act, dtype, device)
    return p


def _ffn_apply(cfg: ModelConfig, ffn: str, p: Params, h):
    """The layer's FFN (every kind but ``rwkv_cm``): the MLP, or the
    routed experts plus the shared one (the aux loss is training's and
    is dropped, as in the reference's serving path)."""
    if ffn == "moe":
        y, _ = MoE.moe_apply(cfg, p["moe"], h)
        return y + L.mlp_apply(p["shared"], h, "silu")
    mk = mlp_kind(cfg)
    if mk == "geglu":
        return L.geglu_apply(p["mlp"], h)
    return L.mlp_apply(p["mlp"], h, "silu" if mk == "swiglu" else "gelu")


def apply_block(cfg: ModelConfig, sig: LayerSig, p: Params, x, positions):
    """Full-sequence training block (state-free): an ``attn``, ``local``
    (the band of ``cfg.local_window``) or ``rglru`` mixer (from a zero
    state) and a dense MLP (``check_trainable``).  Returns (x, aux), aux
    0."""
    mix = sig[0]
    h = L.norm_apply(cfg.norm, p["norm1"], x, cfg.norm_eps)
    if mix == "rglru":
        a, _ = RG.rglru_apply(cfg, p["rglru"], h,
                              RG.state_init(cfg, x.shape[0], x.device))
    elif cfg.attn_kind == "mla":
        a, _ = A.mla_apply(cfg, p["attn"], h, positions)
    else:
        a, _ = A.gqa_apply(cfg, p["attn"], h, positions, window=(
            cfg.local_window if mix == "local" else 0))
    x = x + a
    h = L.norm_apply(cfg.norm, p["norm2"], x, cfg.norm_eps)
    return x + _ffn_apply(cfg, sig[1], p, h), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def block_cache_init(cfg: ModelConfig, sig: LayerSig, batch: int, seq: int,
                     dtype, device) -> Params:
    """One layer's empty decode cache.  An ``rwkv`` layer's is ``{"rwkv":
    {shift_tm, shift_cm, wkv}}`` in float32; the reference's cache also
    holds a ``cm_shift`` key for the ``rwkv_cm`` FFN that nothing reads
    (its decode reads ``shift_cm``), which the port leaves out."""
    mix, _ = sig
    if mix == "attn" and cfg.attn_kind == "mla":
        return {"attn": A.mla_cache_init(cfg, batch, seq, dtype, device)}
    if mix == "attn":
        return {"attn": A.gqa_cache_init(cfg, batch, seq, dtype, device)}
    if mix == "local":
        return {"attn": A.gqa_cache_init(cfg, batch,
                                         min(cfg.local_window, seq), dtype,
                                         device)}
    if mix == "rglru":
        return {"rglru": RG.state_init(cfg, batch, device)}
    return {"rwkv": RW.state_init(cfg, batch, device)}


def _fill_attn_cache(cache: Params, kv, window: int = 0) -> Params:
    """Write prefill K/V (B,S,KV,hd) into a fresh cache, in place
    (ring-buffered for sliding-window layers)."""
    k, v = kv
    s = k.shape[1]
    s_cache = cache["k"].shape[1]
    if not window and s <= s_cache:
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        return cache
    # ring buffer: keep the last s_cache positions at slot (pos % s_cache)
    take = min(s, s_cache)
    gpos = torch.arange(s - take, s, device=k.device)
    slots = gpos % s_cache
    cache["k"][:, slots] = k[:, gpos].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, gpos].to(cache["v"].dtype)
    return cache


def apply_block_prefill(cfg: ModelConfig, sig: LayerSig, p: Params,
                        cache: Params, x, positions):
    """Full-sequence forward that also fills the decode cache.  Recurrent
    states (rglru, rwkv time-mix and channel-mix) start at zero."""
    mix, ffn = sig
    h = L.norm_apply(cfg.norm, p["norm1"], x, cfg.norm_eps)
    b = x.shape[0]
    newc: Params = {}
    if mix == "attn" and cfg.attn_kind == "mla":
        a, (ckv, krope) = A.mla_apply(cfg, p["attn"], h, positions)
        c = cache["attn"]
        s = x.shape[1]
        c["c_kv"][:, :s] = ckv.to(c["c_kv"].dtype)
        c["k_rope"][:, :s] = krope.to(c["k_rope"].dtype)
        newc["attn"] = c
    elif mix in ("attn", "local"):
        window = cfg.local_window if mix == "local" else 0
        a, kv = A.gqa_apply(cfg, p["attn"], h, positions, window=window,
                            kv_out=True)
        newc["attn"] = _fill_attn_cache(cache["attn"], kv, window)
    elif mix == "rglru":
        a, newc["rglru"] = RG.rglru_apply(
            cfg, p["rglru"], h, RG.state_init(cfg, b, x.device))
    else:
        st = RW.state_init(cfg, b, x.device)
        a, shift, wkv = RW.time_mix_apply(cfg, p["rwkv"], h,
                                          st["shift_tm"].to(h.dtype))
        newc["rwkv"] = {"shift_tm": shift.float(),
                        "shift_cm": st["shift_cm"], "wkv": wkv}
    x = x + a
    h = L.norm_apply(cfg.norm, p["norm2"], x, cfg.norm_eps)
    if ffn != "rwkv_cm":
        return x + _ffn_apply(cfg, ffn, p, h), newc
    y, shift_cm = RW.channel_mix_apply(
        p["cm"], h, newc["rwkv"]["shift_cm"].to(h.dtype))
    newc["rwkv"]["shift_cm"] = shift_cm.float()
    return x + y, newc


def apply_block_decode(cfg: ModelConfig, sig: LayerSig, p: Params,
                       cache: Params, x, pos):
    """One-token step. x: (B,1,d); pos: (B,). Returns (x, new_cache)."""
    mix, ffn = sig
    h = L.norm_apply(cfg.norm, p["norm1"], x, cfg.norm_eps)
    newc: Params = {}
    if mix == "attn" and cfg.attn_kind == "mla":
        a, newc["attn"] = A.mla_decode(cfg, p["attn"], h, cache["attn"], pos)
    elif mix in ("attn", "local"):
        window = cfg.local_window if mix == "local" else 0
        a, newc["attn"] = A.gqa_decode(cfg, p["attn"], h, cache["attn"], pos,
                                       window=window)
    elif mix == "rglru":
        a, newc["rglru"] = RG.rglru_decode(cfg, p["rglru"], h, cache["rglru"])
    else:
        st = cache["rwkv"]
        a, shift, wkv = RW.time_mix_decode(cfg, p["rwkv"], h,
                                           st["shift_tm"].to(h.dtype),
                                           st["wkv"])
        newc["rwkv"] = {"shift_tm": shift.float(),
                        "shift_cm": st["shift_cm"], "wkv": wkv}
    x = x + a
    h = L.norm_apply(cfg.norm, p["norm2"], x, cfg.norm_eps)
    if ffn != "rwkv_cm":
        return x + _ffn_apply(cfg, ffn, p, h), newc
    y, shift_cm = RW.channel_mix_decode(
        p["cm"], h, newc["rwkv"]["shift_cm"].to(h.dtype))
    newc["rwkv"]["shift_cm"] = shift_cm.float()
    return x + y, newc


# ---------------------------------------------------------------------------
# Parameters as modules
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each tensor an
    ``nn.Parameter``, frozen as made (serving: no gradients) until
    ``requires_grad_`` (``Model.train_mode``) hands them out trainable,
    each dict a submodule, under the dict's own keys."""

    def __init__(self, tree: Params):
        super().__init__()
        self._keys = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, ParamTree(v))

    def tree(self) -> Params:
        """The parameters as the nested dict they were made from."""
        return {k: v.tree() if isinstance(v, ParamTree) else v
                for k, v in ((k, getattr(self, k)) for k in self._keys)}


class Block(nn.Module):
    """One layer's parameters, keyed as the reference keys them
    (``norm1``, ``norm2``, ``attn``, ``rglru`` or ``rwkv``, and ``mlp``,
    or ``cm`` for ``rwkv_cm``, or ``moe`` and ``shared`` for ``moe``)."""

    def __init__(self, sig: LayerSig, params: Params):
        super().__init__()
        self.sig = sig
        self.p = ParamTree(params)

    def params(self) -> Params:
        return self.p.tree()


# ---------------------------------------------------------------------------
# Whole-model init / prefill / decode
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: Optional[L.Draw],
                device) -> Params:
    """``{"embed", "final_norm", ["lm_head"], "layers": [one dict per
    layer]}``, allocated (``gen`` None; constants filled) or drawn in
    place into ``gen``'s leaves, in this order."""
    dtype = torch_dtype(cfg.param_dtype)
    params: Params = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": L.norm_init(gen, cfg.norm, cfg.d_model, dtype,
                                  device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype, device)
    params["layers"] = [block_init(gen, cfg, sig, dtype, device)
                        for sig in layer_sigs(cfg)]
    return params


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device) -> List[Params]:
    """One cache dict per layer, in layer order, in the compute dtype."""
    dtype = torch_dtype(cfg.compute_dtype)
    return [block_cache_init(cfg, sig, batch, seq, dtype, device)
            for sig in layer_sigs(cfg)]


def _embed(cfg: ModelConfig, params: Params, tokens,
           patch_embeds=None) -> torch.Tensor:
    """Token embeddings in the compute dtype; for the VLM with
    ``patch_embeds`` (B, P, d), the first ``min(P, S)`` positions are the
    patch embeddings instead (cast to the compute dtype), as the
    reference splices them."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = F.embedding(tokens.long(), params["embed"]).to(cdt)
    if cfg.frontend == "vlm" and patch_embeds is not None:
        p = min(patch_embeds.shape[1], x.shape[1])
        x = torch.cat([patch_embeds[:, :p].to(cdt), x[:, p:]], dim=1)
    return x


def prefill(cfg: ModelConfig, params: Params, tokens, cache: List[Params],
            patch_embeds=None):
    """Process a prompt ``tokens`` (B,S) into the empty ``cache`` (of
    ``init_cache``), the VLM's ``patch_embeds`` (B,P,d) spliced over its
    first positions; return (hidden (B,S,d), filled cache)."""
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens, patch_embeds)
    positions = torch.arange(s, device=tokens.device)
    new_cache = []
    for sig, lp, lc in zip(layer_sigs(cfg), params["layers"], cache):
        x, nc = apply_block_prefill(cfg, sig, lp, lc, x, positions)
        new_cache.append(nc)
    x = L.norm_apply(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return x, new_cache


def forward(cfg: ModelConfig, params: Params, tokens, patch_embeds=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B,S) -> (hidden (B,S,d), aux loss), the training forward
    (the VLM's ``patch_embeds`` spliced as in ``prefill``); with
    ``cfg.parallel.remat`` each layer is recomputed in the backward."""
    check_layers_trainable(cfg)
    x = _embed(cfg, params, tokens, patch_embeds)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for sig, lp in zip(layer_sigs(cfg), params["layers"]):
        if cfg.parallel.remat:
            x, aux = checkpoint(apply_block, cfg, sig, lp, x, positions,
                                use_reentrant=False)
        else:
            x, aux = apply_block(cfg, sig, lp, x, positions)
        aux_total = aux_total + aux
    x = L.norm_apply(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return x, aux_total


def _chunk_loss(head, hx, lx):
    """One sequence chunk's (nll sum with z-loss, correct, count)."""
    nll, correct, mask = L.token_losses(hx @ head.to(hx.dtype), lx)
    return nll.sum(), correct.sum(), mask.sum()


def loss_fn(cfg: ModelConfig, params: Params, hidden, labels,
            chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming CE over SEQUENCE chunks of ``chunk`` tokens: each chunk's
    (B, chunk, V) float32 logits are recomputed in the backward, never
    held for the whole sequence.  Labels -1 are masked.  Returns (loss,
    accuracy)."""
    s = hidden.shape[1]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    c = min(chunk, s)
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    nll, correct, denom = zero, zero, zero
    for c0 in range(0, s, c):
        n, k, m = checkpoint(_chunk_loss, head, hidden[:, c0:c0 + c],
                             labels[:, c0:c0 + c], use_reentrant=False)
        nll, correct, denom = nll + n, correct + k, denom + m
    denom = torch.clamp(denom, min=1.0)
    return nll / denom, correct / denom


def logits(cfg: ModelConfig, params: Params, hidden) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (hidden @ head.to(hidden.dtype)).float()


def decode_step(cfg: ModelConfig, params: Params, cache: List[Params],
                tokens, pos):
    """tokens: (B,1); pos: (B,). Returns (logits (B,1,V) float32,
    new_cache)."""
    x = _embed(cfg, params, tokens)
    new_cache = []
    for sig, lp, lc in zip(layer_sigs(cfg), params["layers"], cache):
        x, nc = apply_block_decode(cfg, sig, lp, lc, x, pos)
        new_cache.append(nc)
    x = L.norm_apply(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return logits(cfg, params, x), new_cache
