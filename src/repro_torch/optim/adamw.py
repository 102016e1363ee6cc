"""AdamW with dtype-configurable moment states (fp32 / bf16 / int8): the
twin of the reference's ``repro/optim/adamw.py``, its arithmetic on
tensors.

Parameters, gradients and moments are trees (nested dicts and lists of
tensors, the layout of ``Model.params()``); ``update`` returns new
trees, as the reference does, and the train step copies the new weights
into the model.  The step count and the learning rate are 0-d tensors on
the parameters' device; the bias corrections are float32 powers of
``b1``/``b2``, and the int8 moments round half to even (``torch.round``,
as ``jnp.round``).  No ``torch.optim``.

Weight decay touches the leaves the reference sees as matrices
(``ndim >= 2``).  The reference stacks each segment's layers along a
leading axis, so a layer's vectors (norm scales, biases) reach its
optimizer as ``(layers, d)`` and are decayed; only the top-level vectors
(``final_norm``) are not.  The port keeps one tree per layer: a leaf
inside a list (a layer) counts one more dimension, so the same leaves
are decayed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, map_leaves

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"          # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (float32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


# ---------------------------------------------------------------------------
# Quantized moment storage
# ---------------------------------------------------------------------------

def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with per-row (last-axis) absmax scale."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _store(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quant(x)
    return x.to(getattr(torch, dtype))


def _load(s, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequant(*s)
    return s.float()


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Params
    v: Params


def _stacked(tree, in_layer: bool = False):
    """The tree's layout with each leaf replaced by whether it lies in a
    layer (a list entry): the reference stacks those along a leading
    axis."""
    if isinstance(tree, torch.Tensor):
        return in_layer
    if isinstance(tree, dict):
        return {k: _stacked(v, in_layer) for k, v in tree.items()}
    return [_stacked(v, True) for v in tree]


def init(cfg: AdamWConfig, params: Params) -> AdamWState:
    def zeros(p):
        return _store(torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), cfg.state_dtype)
    dev = leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      map_leaves(zeros, params), map_leaves(zeros, params))


def global_norm(tree: Params) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Params, state: AdamWState,
           params: Params) -> Tuple[Params, AdamWState,
                                    Dict[str, torch.Tensor]]:
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0) if cfg.grad_clip else 1.0
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def leaf(p, g, m_s, v_s, stacked):
        g = g.float() * clip
        m = cfg.b1 * _load(m_s, cfg.state_dtype) + (1 - cfg.b1) * g
        v = cfg.b2 * _load(v_s, cfg.state_dtype) + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and p.dim() + stacked >= 2:   # the reference's
            # "matrices only", on its stacked layout
            upd = upd + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * upd).to(p.dtype)
        return new_p, _store(m, cfg.state_dtype), _store(v, cfg.state_dtype)

    out = map_leaves(leaf, params, grads, state.m, state.v, _stacked(params))
    new_params, new_m, new_v = (map_leaves(lambda _, o: o[i], params, out)
                                for i in range(3))
    return new_params, AdamWState(step, new_m, new_v), \
        {"grad_norm": gnorm, "lr": lr}
