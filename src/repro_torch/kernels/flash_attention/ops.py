"""Public op: flash attention with the grouped-query head layout.

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel (``kernel.flash_attention_cuda``), which reads each
query head's KV head in place; CPU tensors take the plain version
(``ref.flash_attention_ref``), which repeats the KV heads to the query
heads as the reference op (``repro/kernels/flash_attention/ops.py``)
feeds its kernel.
There is no fallback from one to the other: a CUDA launch that cannot
run raises.

When a gradient is wanted (grad mode on and q, k or v requiring it), the
op is ``FlashAttention``, a ``torch.autograd.Function``: on CUDA tensors
its forward is the kernel with the row log-sum-exp as a second output and
its backward the hand-written backward kernels
(``kernel.flash_attention_bwd_cuda``); on CPU tensors both are the plain
versions.  Serving (no gradient) takes the plain call above.

Both take a ``window`` (the ``local`` layers' band: key j hidden from
query i when ``i - j >= window``).  Serving also takes a v head dim
below q's (MLA's 192/128); the gradient does not yet (ROADMAP A9.8e):
asked for one with it, the op raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import aligned
from repro_torch.kernels.flash_attention.kernel import (
    BWD_HEAD_DIMS, flash_attention_bwd_cuda, flash_attention_cuda,
    flash_attention_fwd_lse_cuda)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_fwd_lse_ref, flash_attention_ref)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the kernels on CUDA tensors, the
    plain versions on CPU tensors.  The forward keeps q, k, v, o and the
    row log-sum-exp; the backward recomputes P from them.  ``window`` as
    ``flash_attention``'s."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int = 0):
        dev = q.device.type
        if dev == "cuda":
            if q.shape[-1] not in BWD_HEAD_DIMS:
                raise ValueError(
                    f"head dim {q.shape[-1]}: the flash-attention backward "
                    f"kernel takes {BWD_HEAD_DIMS}")
            q, k, v = aligned(q), aligned(k), aligned(v)
            o, lse = flash_attention_fwd_lse_cuda(q, k, v, causal=causal,
                                                  window=window)
        elif dev == "cpu":
            o, lse = flash_attention_fwd_lse_ref(q, k, v, causal=causal,
                                                 window=window)
        else:
            raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                             f"not {dev}")
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(
                q, k, v, o, aligned(do), lse, causal=ctx.causal,
                window=ctx.window)
        else:
            dq, dk, dv = flash_attention_bwd_ref(
                q, k, v, o, do, lse, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: ``(B, Sq, H, hd)``; k: ``(B, Skv, KV, hd)``; v: ``(B, Skv, KV,
    hdv)`` with ``H % KV == 0``.  Returns ``(B, Sq, H, hdv)`` in q's
    dtype, scores scaled by ``hd ** -0.5``.  ``window`` > 0 (causal,
    ``Sq <= Skv``): key j is visible to query i iff ``j <= i`` and ``i - j
    < window``."""
    if window and (not causal or q.shape[1] > k.shape[1]):
        raise ValueError(f"window {window} needs causal=True and Sq <= Skv, "
                         f"got causal={causal}, Sq {q.shape[1]}, Skv "
                         f"{k.shape[1]}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if v.shape[-1] != q.shape[-1]:
            raise NotImplementedError(
                "the flash-attention gradient with a v head dim other than "
                "q's (ROADMAP A9.8e) is not ported yet")
        return FlashAttention.apply(q, k, v, causal, int(window))
    dev = q.device.type
    if dev == "cuda":
        return flash_attention_cuda(aligned(q), aligned(k), aligned(v),
                                    causal=causal, window=window)
    if dev == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
