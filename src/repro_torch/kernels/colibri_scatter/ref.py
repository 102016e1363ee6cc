"""Plain PyTorch version of the colibri_scatter commit: ``index_add_``.

It is what the CPU path runs and what the CUDA kernel is held against on
the card.  Keys outside ``[0, num_bins)`` are dropped, as the kernel
drops them.  Sums accumulate in float64 and are returned in ``vals``'
dtype: the near-exact sum, whatever order ``index_add_`` adds in (on the
card its atomics add in a different order on every run; a float32 sum
of the ~16 000 rows per bin of a 2^20-row stream then varies by ~1e-3,
more than the tolerance the kernel is held to).
"""
from __future__ import annotations

import torch


def _in_range(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    return (keys >= 0) & (keys < num_bins)


def scatter_add_ref(keys: torch.Tensor, vals: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """``out[b] = sum(vals[keys == b])`` for ``b`` in ``[0, num_bins)``;
    keys ``(T,)``, vals ``(T, ...)`` -> ``(num_bins, ...)``."""
    keep = _in_range(keys, num_bins)
    out = torch.zeros((num_bins,) + tuple(vals.shape[1:]),
                      dtype=torch.float64, device=vals.device)
    out.index_add_(0, keys[keep].long(), vals[keep].to(torch.float64))
    return out.to(vals.dtype)


def histogram_ref(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """int32 count of each key in ``[0, num_bins)``."""
    keep = _in_range(keys, num_bins)
    return torch.bincount(keys[keep].long(),
                          minlength=num_bins).to(torch.int32)
