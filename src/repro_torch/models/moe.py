"""Mixture-of-experts FFN with **colibri dispatch**: the local (one
device) path of the reference's ``repro/models/moe.py``.

Token→expert assignment is a contended-RMW problem: T·k requests racing
for E expert queues of bounded capacity.  The router's picks are
linearized once by a stable sort (``core.dispatch``); each pick gets its
FIFO queue position, the oldest win under capacity pressure
(``LRSCwait_q``: later tokens are dropped, never a random subset), and
the (expert, slot) table is built with one commit per slot.  The experts
then run as three grouped GEMMs over the (E, C, d) dispatch buffer, the
hand-written ``grouped_matmul`` kernel on the card (the reference's
model runs three einsums; its Pallas kernel is reached only from its
tests), and each token gathers its k results back, weighted by its
renormalised gates.

The router weight is float32 in every model (a bf16 model included), as
in the reference.  The sharded path (experts over the data axis, an
``all_to_all`` each way) is not ported yet (ROADMAP A9.6).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch as D
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.models import layers as L

Params = Dict[str, Any]


def moe_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    return {"router": L.dense_init(gen, d, e, torch.float32, device),
            "w_gate": L.normal(gen, (e, d, f), d ** -0.5, dtype, device),
            "w_up": L.normal(gen, (e, d, f), d ** -0.5, dtype, device),
            "w_down": L.normal(gen, (e, f, d), f ** -0.5, dtype, device)}


def shared_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    m = cfg.moe
    return L.mlp_init(gen, cfg.d_model, m.d_ff_expert * m.num_shared_experts,
                      "silu", dtype, device)


def capacity_for(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``num_tokens`` tokens: ``capacity_factor``
    times the mean load, at least 8, at most T·k, rounded up to 8."""
    m = cfg.moe
    t_assign = num_tokens * m.top_k
    cap = int(math.ceil(t_assign * m.capacity_factor / m.num_experts))
    cap = max(cap, 8)
    cap = min(cap, t_assign)
    return int(-(-cap // 8) * 8) if cap >= 8 else cap


def _route(cfg: ModelConfig, router_w, x_flat):
    """Router in float32: top-k expert ids (T, k), their renormalised
    gates (T, k) and the load-balance aux loss E · sum_e f_e · p_e."""
    m = cfg.moe
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gates, ids = torch.topk(probs, m.top_k, dim=-1)             # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    t = x_flat.shape[0]
    f_e = D.histogram(ids.reshape(-1), m.num_experts).float() / (t * m.top_k)
    aux = m.num_experts * torch.sum(f_e * probs.mean(0))
    return ids, gates, aux


def _expert_ffn(w_gate, w_up, w_down, xbuf):
    """xbuf (E, C, d) -> (E, C, d): SwiGLU per expert, three grouped
    GEMMs."""
    h = F.silu(grouped_matmul(xbuf, w_gate))
    h = h * grouped_matmul(xbuf, w_up)
    return grouped_matmul(h, w_down)


def _moe_local(cfg: ModelConfig, p: Params, x_flat
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.moe
    t, d = x_flat.shape
    ids, gates, aux = _route(cfg, p["router"], x_flat)
    keys = ids.reshape(-1)                                      # (T*k,)
    cap = capacity_for(t, cfg)
    src, valid, disp = D.dispatch_indices(keys, m.num_experts, cap)
    token_of = torch.where(valid, src // m.top_k, 0).long()    # slot -> token
    xbuf = torch.where(valid[..., None], x_flat[token_of],
                       torch.zeros((), dtype=x_flat.dtype,
                                   device=x_flat.device))       # (E, C, d)
    ybuf = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], xbuf)
    y_assign = D.combine_from_slots(ybuf, keys, disp.queue_pos, disp.keep,
                                    gates.reshape(-1))
    y = y_assign.reshape(t, m.top_k, d).sum(1)
    return y.to(x_flat.dtype), aux


def moe_apply(cfg: ModelConfig, p: Params, x) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss scalar), the B·S tokens
    routed together."""
    b, s, d = x.shape
    y, aux = _moe_local(cfg, p, x.reshape(b * s, d))
    return y.reshape(b, s, d), aux
