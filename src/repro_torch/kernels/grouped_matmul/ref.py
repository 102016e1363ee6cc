"""Plain PyTorch version of the grouped expert GEMM, as the reference's
oracle (``repro/kernels/grouped_matmul/ref.py``) computes it: an einsum
in float32, cast to x's dtype.  What the CPU path runs and what the CUDA
kernel is held against on the card."""
from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``(E, C, d)``, w ``(E, d, f)`` -> ``(E, C, f)`` in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
