"""Shared neural-net layers of the port (plain PyTorch, explicit params).

The twin of the reference's ``repro/models/layers.py``:

* Params are nested dicts of tensors, keyed as the reference keys them,
  so that a converted JAX parameter tree drops in unchanged.
* Math runs in the config's ``compute_dtype``; norms, softmax and
  recurrent states run in float32.
* Initialisers draw from an explicit ``torch.Generator`` on the device
  the tensors are made on.  Given ``None`` in its place they allocate the
  tensor uninitialised (shapes only): ``Model`` allocates that way and
  then loads drawn or converted weights.  torch's generator gives other
  numbers than ``jax.random`` from the same seed, so parity tests convert
  the reference's weights (``repro_torch.convert.model_from_jax``).

The reference's ``sinusoidal_positions`` and ``cross_entropy`` are not
ported yet: no ported path uses them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def normal(gen: Optional[torch.Generator], shape, std: float, dtype,
           device) -> torch.Tensor:
    """float32 N(0, std^2) draws cast to ``dtype`` (uninitialised when
    ``gen`` is None)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std).to(dtype)


def uniform(gen: Optional[torch.Generator], shape, lo: float, hi: float,
            device) -> torch.Tensor:
    """float32 U[lo, hi) draws (uninitialised when ``gen`` is None)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32) * (hi - lo) + lo


def dense_init(gen, d_in: int, d_out: int, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    return normal(gen, (d_in, d_out), scale / d_in ** 0.5, dtype, device)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm_init(kind: str, d: int, dtype, device) -> Params:
    if kind == "rmsnorm":
        return rmsnorm_init(d, dtype, device)
    return layernorm_init(d, dtype, device)


def norm_apply(kind: str, p: Params, x, eps: float = 1e-5):
    return rmsnorm(p, x, eps) if kind == "rmsnorm" else layernorm(p, x, eps)


def groupnorm(x: torch.Tensor, scale, bias, num_groups: int,
              eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm over the last dim (rwkv6 output norm; eps follows rwkv),
    in float32, cast back to ``x``'s dtype."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, num_groups, d // num_groups)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen, d: int, d_ff: int, act: str, dtype, device) -> Params:
    if act == "silu":                     # gated (SwiGLU / GeGLU layout)
        return {"w_gate": dense_init(gen, d, d_ff, dtype, device),
                "w_up": dense_init(gen, d, d_ff, dtype, device),
                "w_down": dense_init(gen, d_ff, d, dtype, device)}
    return {"w_up": dense_init(gen, d, d_ff, dtype, device),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_down": dense_init(gen, d_ff, d, dtype, device),
            "b_down": torch.zeros((d,), dtype=dtype, device=device)}


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        g = F.silu(x @ p["w_gate"])
        return (g * (x @ p["w_up"])) @ p["w_down"]
    h = gelu(x @ p["w_up"] + p["b_up"])
    return h @ p["w_down"] + p["b_down"]


def geglu_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated GELU (recurrentgemma MLP) — the silu param layout."""
    g = gelu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(rot_dim: int, theta: float, device) -> torch.Tensor:
    i = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / rot_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """x: ``(..., S, H, hd)``; positions: broadcastable to ``(..., S)``."""
    hd = x.shape[-1]
    rot = int(hd * rotary_frac)
    rot -= rot % 2
    if rot == 0:
        return x
    freqs = rope_frequencies(rot, theta, x.device)             # (rot/2,)
    angles = positions[..., None].float() * freqs              # (..., S, rot/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, rot/2)
    sin = torch.sin(angles)[..., None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]           # rotate-half layout
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)
