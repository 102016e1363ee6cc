"""Public op: flash attention with the grouped-query head layout.

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel (``kernel.flash_attention_cuda``), which reads each
query head's KV head in place; CPU tensors take the plain version
(``ref.flash_attention_ref``), which repeats the KV heads to the query
heads as the reference op (``repro/kernels/flash_attention/ops.py``)
feeds its kernel.
There is no fallback from one to the other: a CUDA launch that cannot
run raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import aligned
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: ``(B, Sq, H, hd)``; k, v: ``(B, Skv, KV, hd)`` with
    ``H % KV == 0``.  Returns ``(B, Sq, H, hd)`` in q's dtype."""
    dev = q.device.type
    if dev == "cuda":
        return flash_attention_cuda(aligned(q), aligned(k), aligned(v),
                                    causal=causal)
    if dev == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
