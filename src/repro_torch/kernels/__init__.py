"""Hand-written GPU kernels of the port, each beside its plain version.

Each kernel package provides:
  * ``kernel.py`` — builds the CUDA source (``repro_torch/csrc``) with
    ``nvcc`` at first use, binds it with ``ctypes`` and launches it on
    PyTorch's current stream, counting launches;
  * ``ops.py``    — the public op: CUDA tensors go to the kernel, CPU
    tensors to the plain version;
  * ``ref.py``    — the plain PyTorch version the kernel is held against.

:data:`LAUNCHES` counts each kernel's launches by name in this process;
a wrapper adds one where it launches its kernel and nowhere else.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"engine_step": 0}
