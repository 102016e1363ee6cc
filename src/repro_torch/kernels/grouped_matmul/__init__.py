"""Grouped expert GEMM of the MoE layer: a CUDA kernel and its plain
version.

``(E, C, d) @ (E, d, f) -> (E, C, f)``: one product per expert over its
capacity slots (the colibri-dispatch buffers), float32 sums, output in
x's dtype.  CUDA tensors run the kernel (``csrc/grouped_matmul.cu``),
CPU tensors the plain PyTorch version (``ref.grouped_matmul_ref``).
Launches are counted in ``repro_torch.kernels.LAUNCHES["grouped_matmul"]``.
"""
from repro_torch.kernels.grouped_matmul.ops import grouped_matmul
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

__all__ = ["grouped_matmul", "grouped_matmul_ref"]
