"""Carry engine state between numpy and the port's tensors.

``to_torch`` turns a tree of numpy arrays (bank state, per-core arrays, a
result dict — nested dicts, lists and tuples) into tensors of the same
dtype on a given device; ``to_numpy`` turns a tree of tensors back.
Values that are neither arrays nor tensors (the float metrics of a
result dict, strings) pass through unchanged.  The tests use it to feed
the reference's state to the port and to compare the two.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_torch(tree: Any, device="cpu") -> Any:
    """numpy arrays and numpy scalars -> tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree, copy=True)).to(device)
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
