"""RG-LRU recurrent block (Griffin / recurrentgemma), the twin of the
reference's ``repro/models/rglru.py``.

Recurrence (per channel, float32):
    r_t = σ(α_r ⊙ y_t + β_r)                  (recurrence gate)
    i_t = σ(α_i ⊙ y_t + β_i)                  (input gate)
    log a_t = -c · softplus(Λ) ⊙ r_t          (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ y_t)

Prefill takes ``h`` from the ``rglru_scan`` op (the CUDA kernel on the
card, its plain version on the CPU) where the reference takes an
associative scan; decode is a single step in plain torch, as in the
reference.  State: h ``(B, w)`` + conv1d tail ``(B, cw-1, w)``.

The gates are per-channel affine (element-wise), the reference's
documented simplification of Griffin's block-diagonal gates.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models import layers as L

Params = Dict[str, Any]
C_RGLRU = 8.0


def rglru_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    w = cfg.recurrent.lru_width or d
    cw = cfg.recurrent.conv1d_width

    def zeros():
        return L.full(gen, (w,), 0.0, torch.float32, device)
    return {
        "w_in": L.dense_init(gen, d, w, dtype, device),
        "w_gate": L.dense_init(gen, d, w, dtype, device),
        "conv_w": L.normal(gen, (cw, w), 0.1, dtype, device),
        "conv_b": L.full(gen, (w,), 0.0, dtype, device),
        "alpha_r": zeros(), "beta_r": zeros(),
        "alpha_i": zeros(), "beta_i": zeros(),
        # Λ init so a ≈ 0.9..0.999 at r=1
        "lam": L.uniform(gen, (w,), 2.0, 4.0, device),
        "w_proj": L.dense_init(gen, w, d, dtype, device),
    }


def _conv1d_causal(y, conv_w, conv_b, tail=None):
    """Causal depthwise conv. y: (B,S,w); tail: (B,cw-1,w) carried state."""
    cw = conv_w.shape[0]
    if tail is None:
        tail = torch.zeros((y.shape[0], cw - 1, y.shape[2]), dtype=y.dtype,
                           device=y.device)
    ypad = torch.cat([tail.to(y.dtype), y], dim=1)
    out = sum(ypad[:, i: i + y.shape[1]] * conv_w[i] for i in range(cw))
    new_tail = ypad[:, -(cw - 1):].clone() if cw > 1 else tail
    return out + conv_b, new_tail


def _gates(p, y32):
    r = torch.sigmoid(p["alpha_r"] * y32 + p["beta_r"])
    i = torch.sigmoid(p["alpha_i"] * y32 + p["beta_i"])
    log_a = -C_RGLRU * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * y32)
    return a, x_in


def rglru_apply(cfg: ModelConfig, p: Params, x, state: Params
                ) -> Tuple[torch.Tensor, Params]:
    """x: (B,S,d) -> (out, new_state). state = {"h": (B,w), "conv": (B,cw-1,w)}."""
    gate = L.gelu(x @ p["w_gate"])
    y, new_tail = _conv1d_causal(x @ p["w_in"], p["conv_w"], p["conv_b"],
                                 state["conv"])
    a, x_in = _gates(p, y.float())
    # the scan runs over time-major (T, B, w) streams
    h = rglru_scan(a.transpose(0, 1), x_in.transpose(0, 1),
                   state["h"]).transpose(0, 1)                 # (B,S,w)
    out = (h.to(x.dtype) * gate) @ p["w_proj"]
    return out, {"h": h[:, -1].clone(), "conv": new_tail}


def rglru_decode(cfg: ModelConfig, p: Params, x, state: Params):
    """x: (B,1,d) single step."""
    gate = L.gelu(x @ p["w_gate"])
    y, new_tail = _conv1d_causal(x @ p["w_in"], p["conv_w"], p["conv_b"],
                                 state["conv"])
    a, x_in = _gates(p, y[:, 0].float())
    h = a * state["h"] + x_in
    out = (h[:, None].to(x.dtype) * gate) @ p["w_proj"]
    return out, {"h": h, "conv": new_tail}


def state_init(cfg: ModelConfig, batch: int, device) -> Params:
    w = cfg.recurrent.lru_width or cfg.d_model
    cw = cfg.recurrent.conv1d_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, w), dtype=torch.float32,
                                device=device)}
