"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix,
the twin of the reference's ``repro/models/rwkv6.py``.

Prefill takes the WKV recurrence from the ``rwkv6_wkv`` op (the CUDA
kernel on the card, its plain version on the CPU) where the reference
takes its exact sequential scan; both compute the exact recurrence, with
no chunked factorisation.  Decode is a single step in plain torch, as in
the reference.

State per layer: token-shift (last input) for time-mix and channel-mix,
and the per-head wkv matrix S ∈ R^{hd×hd}, all float32.  ``w0`` and
``u`` are float32 whatever the model's dtype, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_wkv import wkv
from repro_torch.models import layers as L

Params = Dict[str, Any]
LORA_RANK = 64


def time_mix_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    hd = cfg.recurrent.head_dim
    h = d // hd
    return {
        "mu": L.uniform(gen, (5, d), 0.0, 1.0, device, dtype),
        "w_r": L.dense_init(gen, d, d, dtype, device),
        "w_k": L.dense_init(gen, d, d, dtype, device),
        "w_v": L.dense_init(gen, d, d, dtype, device),
        "w_g": L.dense_init(gen, d, d, dtype, device),
        "w_o": L.dense_init(gen, d, d, dtype, device),
        "w0": L.normal(gen, (d,), 1.0, torch.float32, device, mean=-5.0),
        "w_lora_a": L.dense_init(gen, d, LORA_RANK, dtype, device),
        "w_lora_b": L.dense_init(gen, LORA_RANK, d, dtype, device,
                                 scale=0.1),
        "u": L.normal(gen, (h, hd), 0.1, torch.float32, device),
        "gn_scale": L.full(gen, (d,), 1.0, dtype, device),
        "gn_bias": L.full(gen, (d,), 0.0, dtype, device),
    }


def channel_mix_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": L.uniform(gen, (2, d), 0.0, 1.0, device, dtype),
        "w_k": L.dense_init(gen, d, f, dtype, device),
        "w_v": L.dense_init(gen, f, d, dtype, device),
        "w_r": L.dense_init(gen, d, d, dtype, device),
    }


def _shift(x, x_prev):
    """Token shift: value of the previous timestep. x: (B,S,d);
    x_prev: (B,d) carry from the previous segment/step."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _decay(p: Params, xw) -> torch.Tensor:
    """w = exp(-exp(w0 + lora(xw))) in (0, 1), float32."""
    wln = p["w0"] + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    return torch.exp(-torch.exp(wln))


def time_mix_apply(cfg: ModelConfig, p: Params, x, shift_state
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,d); the wkv state starts at zero, as in the reference's
    prefill.  Returns (out, new_shift (B,d), new_wkv (B,H,hd,hd))."""
    b, s, d = x.shape
    hd = cfg.recurrent.head_dim
    h = d // hd
    xp = _shift(x, shift_state)
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x + (xp - x) * mu[i]
    r = (mix(0) @ p["w_r"]).reshape(b, s, h, hd).float()
    k = (mix(1) @ p["w_k"]).reshape(b, s, h, hd).float()
    v = (mix(2) @ p["w_v"]).reshape(b, s, h, hd).float()
    g = F.silu(mix(3) @ p["w_g"])
    w = _decay(p, mix(4)).reshape(b, s, h, hd)
    out, s_fin = wkv(r, k, v, w, p["u"])
    out = out.reshape(b, s, d).to(x.dtype)
    out = L.groupnorm(out, p["gn_scale"], p["gn_bias"], num_groups=h)
    out = (out * g) @ p["w_o"]
    return out, x[:, -1], s_fin


def time_mix_decode(cfg: ModelConfig, p: Params, x, shift_state, wkv_state):
    """Single-token step. x: (B,1,d); wkv_state: (B,H,hd,hd) float32."""
    b, _, d = x.shape
    hd = cfg.recurrent.head_dim
    h = d // hd
    xp = shift_state[:, None]
    mu = p["mu"].to(x.dtype)

    def mix(i):
        return x + (xp - x) * mu[i]
    r = (mix(0) @ p["w_r"]).reshape(b, h, hd).float()
    k = (mix(1) @ p["w_k"]).reshape(b, h, hd).float()
    v = (mix(2) @ p["w_v"]).reshape(b, h, hd).float()
    g = F.silu(mix(3) @ p["w_g"])
    w = _decay(p, mix(4)).reshape(b, h, hd)
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r,
                       wkv_state + p["u"][None, :, :, None] * kv)
    s_new = w[..., None] * wkv_state + kv
    out = out.reshape(b, 1, d).to(x.dtype)
    out = L.groupnorm(out, p["gn_scale"], p["gn_bias"], num_groups=h)
    out = (out * g) @ p["w_o"]
    return out, x[:, -1], s_new


def _channel_mix(p: Params, x, xp):
    mu = p["mu"].to(x.dtype)
    xk = x + (xp - x) * mu[0]
    xr = x + (xp - x) * mu[1]
    k = torch.square(F.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"]), x[:, -1]


def channel_mix_apply(p: Params, x, shift_state):
    """x: (B,S,d) -> (out, new_shift (B,d))."""
    return _channel_mix(p, x, _shift(x, shift_state))


def channel_mix_decode(p: Params, x, shift_state):
    """Single-token step. x: (B,1,d) -> (out, new_shift (B,d))."""
    return _channel_mix(p, x, shift_state[:, None])


def state_init(cfg: ModelConfig, batch: int, device) -> Params:
    d = cfg.d_model
    hd = cfg.recurrent.head_dim
    h = d // hd

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"shift_tm": zeros(batch, d), "shift_cm": zeros(batch, d),
            "wkv": zeros(batch, h, hd, hd)}
