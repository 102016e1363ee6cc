"""Hand-written GPU kernels of the port, each beside its plain version.

Each kernel package provides:
  * ``kernel.py`` — binds the CUDA source (``repro_torch/csrc``), built
    with ``nvcc`` at first use by ``_build``, through ``ctypes`` and
    launches it on PyTorch's current stream, counting launches;
  * ``ops.py``    — the public op: CUDA tensors go to the kernel, CPU
    tensors to the plain version;
  * ``ref.py``    — the plain PyTorch version the kernel is held against.

:data:`LAUNCHES` counts each kernel's launches by name in this process;
a wrapper adds one where it launches its kernel and nowhere else.
"""
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"engine_step": 0, "engine_run": 0,
                            "colibri_scatter": 0,
                            "flash_attention": 0,
                            "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkdv": 0, "rglru_scan": 0,
                            "rglru_scan_bwd": 0, "rwkv6_wkv": 0,
                            "grouped_matmul": 0}


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (the kernels'
    16-byte loads need it): a copy only when it is not already."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
