"""Retry-free scatter-add: a CUDA kernel and its plain version.

The paper's Colibri discipline as a tensor op: a stable sort of the keys
is the linearization point (the enqueue), and a segmented commit writes
each bin exactly once (no atomics, no retries).  CUDA tensors run the
commit kernel (``csrc/colibri_scatter.cu``), CPU tensors the plain
PyTorch version (``ref.scatter_add_ref``).  Launches are counted in
``repro_torch.kernels.LAUNCHES["colibri_scatter"]``.
"""
from repro_torch.kernels.colibri_scatter.ops import (colibri_histogram,
                                                     colibri_scatter_add)
from repro_torch.kernels.colibri_scatter.ref import (histogram_ref,
                                                     scatter_add_ref)

__all__ = ["colibri_histogram", "colibri_scatter_add", "histogram_ref",
           "scatter_add_ref"]
