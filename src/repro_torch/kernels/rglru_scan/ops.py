"""Public op: the RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t``.

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel (``kernel.rglru_scan_cuda``), CPU tensors take the
plain version (``ref.rglru_scan_ref``).  There is no fallback from one
to the other: a CUDA launch that cannot run raises.

When a gradient is wanted (grad mode on and a, b or h0 requiring it), the
op is ``RglruScan``, a ``torch.autograd.Function`` whose backward is the
adjoint scan: on CUDA tensors one launch of the kernel over the reversed
time axis (``kernel.rglru_scan_bwd_cuda``), on CPU tensors
``ref.rglru_scan_bwd_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd_cuda,
                                                   rglru_scan_cuda,
                                                   unit_along_w)
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)


class RglruScan(torch.autograd.Function):
    """The scan with its gradient: the kernel forward and backward on CUDA
    tensors, the plain versions on CPU tensors.  The forward keeps a, h
    and h0; the gradients are float32, cast to the inputs' dtypes."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan(a, b, h0)
        ctx.dtypes = (a.dtype, b.dtype, h0.dtype)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        if a.device.type == "cuda":
            grads = rglru_scan_bwd_cuda(a.float(), h, h0.float(), dh)
        else:
            grads = rglru_scan_bwd_ref(a, h, h0, dh)
        return tuple(g.to(dt) for g, dt in zip(grads, ctx.dtypes))


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """a, b: ``(T, B, w)``; h0: ``(B, w)``.  Returns h ``(T, B, w)``
    float32; on the card with a's strides, so the ``(T, B, w)`` view of a
    contiguous ``(B, T, w)`` tensor gets the same view back, and no
    copy is made of inputs whose last axis has unit stride."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                    or h0.requires_grad):
        return RglruScan.apply(a, b, h0)
    return _scan(a, b, h0)


def _scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
          ) -> torch.Tensor:
    dev = a.device.type
    if dev == "cuda":
        # the kernel reads any strides along T and B
        return rglru_scan_cuda(*(x if unit_along_w(x) else x.contiguous()
                                 for x in (y.float() for y in (a, b, h0))))
    if dev == "cpu":
        return rglru_scan_ref(a, b, h0)
    raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not {dev}")
