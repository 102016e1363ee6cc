"""Carry engine state between numpy and the port's tensors.

``to_torch`` turns a tree of numpy arrays (bank state, per-core arrays, a
result dict — nested dicts, lists and tuples) into tensors of the same
dtype on a given device (the GPU by default); ``to_numpy`` turns a tree
of tensors back.
Values that are neither arrays nor tensors (the float metrics of a
result dict, strings) pass through unchanged.  The tests use it to feed
the reference's state to the port and to compare the two.

``model_from_jax`` builds the port's LM from the reference's parameter
tree (as numpy arrays), so that both packages run on the same weights;
``unstack_segments`` turns the reference's per-segment stacked layer
trees (params or decode caches) into the port's one tree per layer, and
``stack_segments`` back; the encoder-decoder's stacked ``enc_blocks``
become its ``enc_layers`` the same way.  ``params_to_numpy``, ``adamw_state_from_jax``
and ``adamw_state_to_numpy`` carry parameters (or gradients) and AdamW
moments between the two layouts; ``load_jax_checkpoint`` reads a
checkpoint that the reference's ``Checkpointer`` wrote into the port's
parameters and optimizer state.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.sim import resolve_device
from repro_torch.models import Model, build
from repro_torch.models.transformer import init_params, plan_segments
from repro_torch.optim import AdamWState
from repro_torch.tree import map_leaves


def to_torch(tree: Any, device=None) -> Any:
    """numpy arrays and numpy scalars -> tensors on ``device`` (the GPU by
    default: without one it raises, as ``build`` does)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        arr = np.array(tree, copy=True)
        if arr.dtype.name == "bfloat16":         # ml_dtypes' bfloat16
            return torch.from_numpy(arr.view(np.uint16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device)
    return tree


def to_numpy(tree: Any) -> Any:
    """tensors -> numpy arrays (0-d tensors become 0-d arrays)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _take(tree, r):
    """Entry ``r`` of the leading (stacked) axis of every leaf."""
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):        # an int8 moment (q, scale)
        return tuple(_take(v, r) for v in tree)
    return tree[r]


def _stack(trees):
    """The trees' leaves stacked along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):       # an int8 moment (q, scale)
        return tuple(_stack([t[i] for t in trees])
                     for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return np.stack(trees)


def unstack_segments(cfg, segments: List[Any]) -> List[Any]:
    """The reference's ``[segment tree, ...]`` (each ``{"u0": ..., "u1":
    ...}`` with a leading repeat axis, as ``plan_segments`` lays the
    layers out) -> one tree per layer, in layer order."""
    layers = []
    for (unit, repeats), seg in zip(plan_segments(cfg), segments):
        for r in range(repeats):
            layers.extend(_take(seg[f"u{j}"], r) for j in range(len(unit)))
    return layers


def model_from_jax(cfg, params_np: dict, device=None) -> Model:
    """The port's ``Model`` of ``cfg`` on ``device`` (the GPU by default:
    without one it raises, as ``build`` does) holding the weights of the
    reference's parameter tree ``params_np`` (numpy arrays: ``embed``,
    ``final_norm``, ``lm_head`` when untied, and the stacked
    ``segments``; the encoder-decoder's also ``pos_embed``, ``enc_norm``
    and the stacked ``enc_blocks``)."""
    dev = resolve_device(device)
    return build(cfg, dev).load_params(to_torch(_to_layers(cfg, params_np),
                                                dev))


def stack_segments(cfg, layers: List[Any]) -> List[Any]:
    """The inverse of ``unstack_segments``: one tree per layer (numpy
    arrays or tensors) -> the reference's ``[segment tree, ...]``, each
    leaf stacked along a leading repeat axis."""
    segments, i = [], 0
    for unit, repeats in plan_segments(cfg):
        n = len(unit)
        segments.append({f"u{j}": _stack([layers[i + r * n + j]
                                          for r in range(repeats)])
                         for j in range(n)})
        i += n * repeats
    return segments


def _to_layers(cfg, tree: Dict[str, Any]) -> Dict[str, Any]:
    """A reference tree (``segments``, and ``enc_blocks``, stacked) -> the
    port's (``layers``, and ``enc_layers``)."""
    out = {k: v for k, v in tree.items()
           if k not in ("segments", "enc_blocks")}
    if "enc_blocks" in tree:
        out["enc_layers"] = [_take(tree["enc_blocks"], r)
                             for r in range(cfg.encoder.num_layers)]
    out["layers"] = unstack_segments(cfg, tree["segments"])
    return out


def _to_segments(cfg, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree (``layers``, and ``enc_layers``) -> the reference's
    (``segments``, and ``enc_blocks``)."""
    out = {k: v for k, v in tree.items() if k not in ("layers", "enc_layers")}
    if "enc_layers" in tree:
        out["enc_blocks"] = _stack(tree["enc_layers"])
    out["segments"] = stack_segments(cfg, tree["layers"])
    return out


def params_to_numpy(cfg, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters (or gradients, or one moment tree) -> numpy
    in the reference's layout (``segments`` stacked), bfloat16 as
    float32."""
    def host(t):
        if isinstance(t, tuple):
            return tuple(host(x) for x in t)
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _to_segments(cfg, map_leaves(host, tree))


def adamw_state_from_jax(cfg, state_np, device=None) -> AdamWState:
    """The reference's ``AdamWState`` as numpy arrays (``step``, ``m``,
    ``v`` in its layout; int8 moments ``(q, scale)`` pairs) -> the port's
    on ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    step, m, v = state_np
    return AdamWState(to_torch(np.asarray(step), dev),
                      to_torch(_to_layers(cfg, m), dev),
                      to_torch(_to_layers(cfg, v), dev))


def adamw_state_to_numpy(cfg, state: AdamWState):
    """The port's ``AdamWState`` -> ``(step, m, v)`` as numpy in the
    reference's layout (wrap in ``repro.optim.AdamWState`` to use it
    there), bfloat16 moments as float32."""
    return (state.step.detach().cpu().numpy(), params_to_numpy(cfg, state.m),
            params_to_numpy(cfg, state.v))


def load_jax_checkpoint(cfg, directory: str, step: int, device=None,
                        state_dtype: Optional[str] = None) -> Dict[str, Any]:
    """A checkpoint that the reference's ``Checkpointer`` wrote of
    ``{"params": ..., "opt": AdamWState}`` (``<directory>/step_<step>``)
    -> ``{"params": the port's parameter tree, "opt": the port's
    AdamWState}`` on ``device`` (the GPU by default); its moments stored
    as ``state_dtype`` (``cfg.parallel.opt_state_dtype`` by default)."""
    dev = resolve_device(device)
    params = init_params(cfg, None, dev)
    opt = optim.init(optim.AdamWConfig(
        state_dtype=state_dtype or cfg.parallel.opt_state_dtype), params)
    got = Checkpointer(directory).restore(step, {
        "params": _to_segments(cfg, params),
        "opt": AdamWState(opt.step, _to_segments(cfg, opt.m),
                          _to_segments(cfg, opt.v))})
    opt = got["opt"]
    return {"params": _to_layers(cfg, got["params"]),
            "opt": AdamWState(opt.step, _to_layers(cfg, opt.m),
                              _to_layers(cfg, opt.v))}
