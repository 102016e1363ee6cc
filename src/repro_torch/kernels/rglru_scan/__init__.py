"""The RG-LRU linear recurrence: a CUDA kernel and its plain version.

``h_t = a_t * h_{t-1} + b_t`` over ``(T, B, w)`` in float32, the prefill
recurrence of the LM's ``rglru`` layers.  CUDA tensors run the kernel
(``csrc/rglru_scan.cu``), CPU tensors the plain PyTorch version
(``ref.rglru_scan_ref``).  Launches are counted in
``repro_torch.kernels.LAUNCHES["rglru_scan"]``.  Its gradient
(``ops.RglruScan``, taken when one is wanted) is the same kernel over the
reversed time axis (``LAUNCHES["rglru_scan_bwd"]``) or
``ref.rglru_scan_bwd_ref``.
"""
from repro_torch.kernels.rglru_scan.ops import RglruScan, rglru_scan
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)

__all__ = ["RglruScan", "rglru_scan", "rglru_scan_bwd_ref",
           "rglru_scan_ref"]
