"""Public op: the grouped expert GEMM.

The device of the tensors picks the path: CUDA tensors launch the
hand-written kernel (``kernel.grouped_matmul_cuda``), CPU tensors take
the plain version (``ref.grouped_matmul_ref``).  There is no fallback
from one to the other: a CUDA launch that cannot run raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import aligned
from repro_torch.kernels.grouped_matmul.kernel import grouped_matmul_cuda
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """MoE expert GEMM over dispatch buffers: x ``(E, C, d)`` @ w ``(E,
    d, f)`` -> ``(E, C, f)`` in x's dtype, float32 sums."""
    dev = x.device.type
    if dev == "cuda":
        return grouped_matmul_cuda(aligned(x), aligned(w))
    if dev == "cpu":
        return grouped_matmul_ref(x, w)
    raise ValueError(f"grouped_matmul runs on cuda or cpu tensors, not {dev}")
