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
trees (params or decode caches) into the port's one tree per layer.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.core.sim import resolve_device
from repro_torch.models import Model, build
from repro_torch.models.transformer import plan_segments


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


def unstack_segments(cfg, segments: List[Any]) -> List[Any]:
    """The reference's ``[segment tree, ...]`` (each ``{"u0": ..., "u1":
    ...}`` with a leading repeat axis, as ``plan_segments`` lays the
    layers out) -> one tree per layer, in layer order."""
    def take(tree, r):
        if isinstance(tree, dict):
            return {k: take(v, r) for k, v in tree.items()}
        return tree[r]

    layers = []
    for (unit, repeats), seg in zip(plan_segments(cfg), segments):
        for r in range(repeats):
            layers.extend(take(seg[f"u{j}"], r) for j in range(len(unit)))
    return layers


def model_from_jax(cfg, params_np: dict, device=None) -> Model:
    """The port's ``Model`` of ``cfg`` on ``device`` (the GPU by default:
    without one it raises, as ``build`` does) holding the weights of the
    reference's parameter tree ``params_np`` (numpy arrays: ``embed``,
    ``final_norm``, ``lm_head`` when untied, and the stacked
    ``segments``)."""
    dev = resolve_device(device)
    tree = {k: v for k, v in params_np.items() if k != "segments"}
    tree["layers"] = unstack_segments(cfg, params_np["segments"])
    return build(cfg, dev).load_params(to_torch(tree, dev))
