"""Colibri ordered-commit: the torch twin of the reference's
``repro/core/dispatch.py``.

Contended scatter-RMW (histogram bins, MoE expert slots) is linearized
once by a stable sort of the request keys: requests to one address form
a contiguous segment in arrival order (the FIFO of Colibri's queue),
each request gets its queue position, and one writer per address
commits.  Nothing retries.  Capacity-bounded dispatch keeps the *oldest*
``capacity`` requests of each bin (``LRSCwait_q``), never a random
subset.

Plain PyTorch, no kernel (the reference has none here either).  Queue
positions, counts, ``keep``, the dispatch table and its ``valid`` mask
are integers equal to the reference's; float sums follow the same
sorted cumulative-sum form.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Dispatch(NamedTuple):
    """Result of colibri dispatch of T requests onto ``num_bins`` queues."""
    queue_pos: torch.Tensor   # (T,) int32 — FIFO rank of each request in its bin
    counts: torch.Tensor      # (num_bins,) int32 — requests per bin
    keep: torch.Tensor        # (T,) bool — rank < capacity (all True if no cap)


def _bins(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    return torch.arange(num_bins, dtype=keys.dtype, device=keys.device)


def queue_positions(keys: torch.Tensor, num_bins: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIFO queue position of each request within its bin, plus bin
    counts.  keys: (T,) integers in [0, num_bins); the stable sort keeps
    program order within a bin (starvation freedom)."""
    t = keys.shape[0]
    sk, order = torch.sort(keys, stable=True)
    seg_start = torch.searchsorted(sk, _bins(keys, num_bins))
    rank_sorted = (torch.arange(t, dtype=torch.int32, device=keys.device)
                   - seg_start[sk.long()].int())
    # invert the permutation: unique destinations -> single-writer commit
    queue_pos = torch.zeros((t,), dtype=torch.int32, device=keys.device)
    queue_pos[order] = rank_sorted
    counts = torch.bincount(keys.long(), minlength=num_bins)[:num_bins].int()
    return queue_pos, counts


def dispatch(keys: torch.Tensor, num_bins: int,
             capacity: Optional[int] = None) -> Dispatch:
    qp, counts = queue_positions(keys, num_bins)
    keep = qp < capacity if capacity is not None else torch.ones_like(
        qp, dtype=torch.bool)
    return Dispatch(qp, counts, keep)


def dispatch_indices(keys: torch.Tensor, num_bins: int, capacity: int,
                     d: Optional[Dispatch] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dispatch]:
    """The (num_bins, capacity) gather table of source indices.

    Returns (src_idx, valid, dispatch): ``src_idx[e, c]`` is the request
    occupying slot c of bin e (T where the slot is empty), ``valid``
    marks occupied slots.  Kept requests have unique slots; dropped ones
    all go to one extra sentinel slot, which is cut off (the reference's
    ``.at[...].set(mode="drop")``)."""
    t = keys.shape[0]
    d = d if d is not None else dispatch(keys, num_bins, capacity)
    n_slots = num_bins * capacity
    flat = keys.long() * capacity + torch.clamp(d.queue_pos, max=capacity - 1)
    src = torch.full((n_slots + 1,), t, dtype=torch.int32, device=keys.device)
    src[torch.where(d.keep, flat, n_slots)] = torch.arange(
        t, dtype=torch.int32, device=keys.device)
    src = src[:n_slots].reshape(num_bins, capacity)
    return src, src < t, d


def ordered_segment_sum(keys: torch.Tensor, values: torch.Tensor,
                        num_bins: int) -> torch.Tensor:
    """Sort-linearized segment sum: ``zeros.index_add_(0, keys, values)``
    with one ordered commit per bin.  values: (T, ...) -> (num_bins, ...)."""
    sk, order = torch.sort(keys, stable=True)
    sv = values[order].float()
    csum = torch.cumsum(sv, dim=0)
    bins = _bins(keys, num_bins)
    ends = torch.searchsorted(sk, bins, right=True)
    starts = torch.searchsorted(sk, bins, right=False)
    zero = torch.zeros((1,) + tuple(sv.shape[1:]), dtype=sv.dtype,
                       device=sv.device)
    padded = torch.cat([zero, csum], dim=0)                 # (T+1, ...)
    return (padded[ends] - padded[starts]).to(values.dtype)


def histogram(keys: torch.Tensor, num_bins: int) -> torch.Tensor:
    """The paper's benchmark op: concurrent bin increments, polling-free."""
    ones = torch.ones(keys.shape, dtype=torch.float32, device=keys.device)
    return ordered_segment_sum(keys, ones, num_bins).int()


def ordered_segment_reduce(keys: torch.Tensor, values: torch.Tensor,
                           num_bins: int, op: str = "add") -> torch.Tensor:
    """add / max / min per bin; empty bins hold the identity (0, -inf,
    inf).  max and min commit each sorted request once into its (bin,
    queue position) cell of a padded table and reduce each bin's row —
    the same exact result as the reference's segmented scan."""
    if op == "add":
        return ordered_segment_sum(keys, values, num_bins)
    ident = {"max": -torch.inf, "min": torch.inf}[op]
    qp, counts = queue_positions(keys, num_bins)
    width = max(int(counts.max()), 1) if keys.shape[0] else 1
    table = torch.full((num_bins, width), ident, dtype=torch.float32,
                       device=values.device)
    table[keys.long(), qp.long()] = values.float()
    out = table.amax(1) if op == "max" else table.amin(1)
    return out.to(values.dtype)


def combine_from_slots(buffer: torch.Tensor, keys: torch.Tensor,
                       queue_pos: torch.Tensor, keep: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Inverse of dispatch: each request's result from its (bin,
    queue_pos) slot, 0 for dropped ones.  buffer: (num_bins, capacity, D)."""
    cap = buffer.shape[1]
    qp = torch.clamp(queue_pos, max=cap - 1).long()
    out = buffer[keys.long(), qp]                           # (T, D)
    out = torch.where(keep[:, None], out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
    if weights is not None:
        out = out * weights[:, None].to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# Retry-based reference (the "LRSC" baseline the paper replaces)
# ---------------------------------------------------------------------------

def lrsc_scatter_add(keys: torch.Tensor, values: torch.Tensor,
                     num_bins: int) -> torch.Tensor:
    """Native scatter-add: duplicate keys are combined at the destination
    (the SPMD analogue of the SC retry loop).  Correctness oracle."""
    out = torch.zeros((num_bins,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, keys.long(), values)
