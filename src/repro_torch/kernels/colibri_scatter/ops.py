"""Public ops: colibri_scatter_add = sort-linearize (enqueue) + commit.

The device of the tensors picks the path: CUDA tensors sort the keys
(``torch.argsort(stable=True)``, the linearization point) and launch the
hand-written commit kernel (``kernel.scatter_commit_cuda``); CPU tensors
take the plain version (``ref.scatter_add_ref``).  There is no fallback
from one to the other: a CUDA launch that cannot run raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.colibri_scatter.kernel import scatter_commit_cuda
from repro_torch.kernels.colibri_scatter.ref import scatter_add_ref


def colibri_scatter_add(keys: torch.Tensor, vals: torch.Tensor,
                        num_bins: int) -> torch.Tensor:
    """Retry-free scatter-add: sort once (linearization point), commit
    once per bin.  keys: ``(T,)`` int32 in ``[0, num_bins)`` (others are
    dropped); vals: ``(T, d)`` or ``(T,)``."""
    squeeze = vals.dim() == 1
    if squeeze:
        vals = vals[:, None]
    dev = keys.device.type
    if dev == "cuda":
        order = torch.argsort(keys, stable=True)
        out = scatter_commit_cuda(keys[order].contiguous(),
                                  vals[order].contiguous(), num_bins)
    elif dev == "cpu":
        out = scatter_add_ref(keys, vals, num_bins)
    else:
        raise ValueError(f"colibri_scatter_add runs on cuda or cpu "
                         f"tensors, not {dev}")
    return out[:, 0] if squeeze else out


def colibri_histogram(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """The paper's benchmark op: int32 count of each key, through the
    commit."""
    ones = torch.ones((keys.shape[0],), dtype=torch.float32,
                      device=keys.device)
    return colibri_scatter_add(keys, ones, num_bins).to(torch.int32)
