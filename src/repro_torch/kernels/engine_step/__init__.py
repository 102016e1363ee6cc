"""Fused per-cycle engine step: a CUDA kernel and its plain version.

One pass fusing the three bank-side stages of the cycle-level engine
(``repro_torch.core.sim``): per-bank FIFO arbitration, the protocol's
dense bank update (``Protocol.fused_access``) and the completion-latency
histogram.  CUDA tensors run the kernel (``csrc/engine_step.cu``), CPU
tensors the plain PyTorch version (``ref.fused_step_ref``).  Launches
are counted in ``repro_torch.kernels.LAUNCHES["engine_step"]``.
"""
from repro_torch.kernels.engine_step.ops import fused_step, outcome_counts
from repro_torch.kernels.engine_step.ref import fused_step_ref

__all__ = ["fused_step", "fused_step_ref", "outcome_counts"]
