"""The simulator's engine kernels and their plain versions.

``fused_step``: one pass fusing the three bank-side stages of a cycle
of the engine (``repro_torch.core.sim``): per-bank FIFO arbitration, the
protocol's dense bank update (``Protocol.fused_access``) and the
completion-latency histogram.  CUDA tensors run the per-cycle kernel
(``csrc/engine_step.cu``), CPU tensors the plain PyTorch version
(``ref.fused_step_ref``); launches are counted in
``repro_torch.kernels.LAUNCHES["engine_step"]``.

``run_cuda``: a whole run in one launch of the ``engine_run`` kernel (same
source), ``core.sim.simulate``'s path on a GPU; its plain version is the
loop ``core.sim._simulate_plain``.  Launches are counted in
``LAUNCHES["engine_run"]``.
"""
from repro_torch.kernels.engine_step.kernel import run_cuda, run_scalars
from repro_torch.kernels.engine_step.ops import fused_step, outcome_counts
from repro_torch.kernels.engine_step.ref import fused_step_ref

__all__ = ["fused_step", "fused_step_ref", "outcome_counts", "run_cuda",
           "run_scalars"]
