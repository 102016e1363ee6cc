"""Shared neural-net layers of the port (plain PyTorch, explicit params).

The twin of the reference's ``repro/models/layers.py``:

* Params are nested dicts of tensors, keyed as the reference keys them,
  so that a converted JAX parameter tree drops in unchanged.
* Math runs in the config's ``compute_dtype``; norms, softmax and
  recurrent states run in float32.
* Initialisers take ``gen``: ``None`` allocates each leaf (random ones
  uninitialised, constant ones filled), a ``Draw`` draws into the
  leaves of an existing model, in place, in the order the initialisers
  create them.  ``Model`` allocates at build and draws at ``init``, so
  seeding a model costs no second copy of its weights: a large leaf (an
  expert stack, the embedding) is drawn ``DRAW_CHUNK`` elements at a
  time along its leading axis.  torch's generator gives other numbers
  than ``jax.random`` from the same seed, so parity tests convert the
  reference's weights (``repro_torch.convert.model_from_jax``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

#: float32 elements drawn at once into a leaf (256 MB)
DRAW_CHUNK = 1 << 26


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

class Draw:
    """Draws from ``gen`` into existing tensors ``leaves``, which must
    come in the order the initialisers ask for them (the order
    ``transformer.init_params`` creates a model's leaves, which is the
    order of its parameter tree)."""

    def __init__(self, gen: torch.Generator, leaves: Iterable[torch.Tensor]):
        self.gen = gen
        self._leaves = iter(leaves)

    def target(self, shape, dtype) -> torch.Tensor:
        t = next(self._leaves, None)
        if t is None or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            got = "none" if t is None else f"{t.dtype}{tuple(t.shape)}"
            raise ValueError(f"the next leaf is {got}, the initialiser "
                             f"draws {dtype}{tuple(shape)}")
        return t

    def done(self) -> None:
        """Raise unless every leaf was drawn."""
        if next(self._leaves, None) is not None:
            raise ValueError("leaves left undrawn")


def _draw(gen: Optional[Draw], shape, dtype, device,
          sample: Callable[[tuple, Any], torch.Tensor]) -> torch.Tensor:
    """The leaf of ``shape``: allocated uninitialised (``gen`` None) or
    ``gen``'s next target, filled with ``sample(chunk shape, device)``
    (float32 draws) a few leading rows at a time."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    out = gen.target(shape, dtype)
    rows = out.view(out.shape[0], -1)
    step = max(1, DRAW_CHUNK // max(1, rows.shape[1]))
    for i in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - i)
        rows[i:i + n] = sample((n, rows.shape[1]), out.device)
    return out


def normal(gen: Optional[Draw], shape, std: float, dtype, device,
           mean: float = 0.0) -> torch.Tensor:
    """float32 N(mean, std^2) draws cast to ``dtype``."""
    return _draw(gen, shape, dtype, device, lambda s, dev: torch.randn(
        s, generator=gen.gen, device=dev) * std + mean)


def uniform(gen: Optional[Draw], shape, lo: float, hi: float, device,
            dtype=torch.float32) -> torch.Tensor:
    """float32 U[lo, hi) draws cast to ``dtype``."""
    return _draw(gen, shape, dtype, device, lambda s, dev: torch.rand(
        s, generator=gen.gen, device=dev) * (hi - lo) + lo)


def full(gen: Optional[Draw], shape, value: float, dtype,
         device) -> torch.Tensor:
    """A constant leaf (norm scales, biases), filled at allocation too."""
    if gen is None:
        return torch.full(shape, value, dtype=dtype, device=device)
    return gen.target(shape, dtype).fill_(value)


def dense_init(gen, d_in: int, d_out: int, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    return normal(gen, (d_in, d_out), scale / d_in ** 0.5, dtype, device)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(gen, d: int, dtype, device) -> Params:
    return {"scale": full(gen, (d,), 1.0, dtype, device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(gen, d: int, dtype, device) -> Params:
    return {"scale": full(gen, (d,), 1.0, dtype, device),
            "bias": full(gen, (d,), 0.0, dtype, device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm_init(gen, kind: str, d: int, dtype, device) -> Params:
    if kind == "rmsnorm":
        return rmsnorm_init(gen, d, dtype, device)
    return layernorm_init(gen, d, dtype, device)


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
            "b_up": full(gen, (d_ff,), 0.0, dtype, device),
            "w_down": dense_init(gen, d_ff, d, dtype, device),
            "b_down": full(gen, (d,), 0.0, dtype, device)}


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


# ---------------------------------------------------------------------------
# Sinusoidal positions (whisper's decoder)
# ---------------------------------------------------------------------------

def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """float32 ``(..., d)`` rows of the reference's sinusoidal table at
    ``positions`` (any integer shape): sin on even columns, cos on odd
    ones, of ``pos / 10000 ** (2i / d)``: the exponent in float32 as the
    reference rounds it, the power correctly rounded (taken in float64),
    one row at a time, so prefill's table and decode's one row agree at
    every position."""
    expo = torch.arange(0, d, 2, dtype=torch.float32,
                        device=positions.device) / d
    div = torch.pow(10000.0, expo.double()).float()
    ang = positions.float()[..., None] / div
    out = torch.zeros((*positions.shape, d), dtype=torch.float32,
                      device=positions.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang[..., : d // 2])
    return out


def sinusoidal_positions(max_len: int, d: int, device) -> torch.Tensor:
    """The reference's ``sinusoidal_positions``: float32 ``(max_len, d)``,
    row i the ``sinusoidal`` row of position i."""
    return sinusoidal(torch.arange(max_len, device=device), d)


# ---------------------------------------------------------------------------
# Cross entropy
# ---------------------------------------------------------------------------

def token_losses(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4):
    """Per token, float32: (nll with z-loss, correct, mask), each zero
    where labels == -1."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.take_along_dim(
        lf, labels.clamp(min=0).long()[..., None], dim=-1)[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (labels >= 0).float()
    return nll * mask, (lf.argmax(-1) == labels) * mask, mask


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token CE in float32 with optional z-loss. labels == -1 is
    masked.

    Returns (loss, accuracy)."""
    nll, correct, mask = token_losses(logits, labels, z_loss)
    denom = torch.clamp(mask.sum(), min=1.0)
    return nll.sum() / denom, correct.sum() / denom
