"""Public op: one fused bank-side engine step.

``fused_step`` is what ``core.sim`` calls once per simulated cycle.  The
device of the tensors picks the path: CUDA tensors launch the hand-written
CUDA kernel (``kernel.fused_step_cuda``), CPU tensors take the plain
PyTorch version (``ref.fused_step_ref``).  There is no fallback from
one to the other: a CUDA launch that cannot run raises.  Both return the
same dict, so the engine's outcome-apply code is device-agnostic.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.protocols.base import (OUT_DONE, OUT_FAIL, OUT_GRANT,
                                             OUT_SLEEP)
from repro_torch.kernels.engine_step.kernel import fused_step_cuda
from repro_torch.kernels.engine_step.ref import fused_step_ref


def outcome_counts(kind: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-cycle tallies of the fused step's ``OUT_*`` outcome codes."""
    return dict(grants=(kind == OUT_GRANT).sum(dtype=torch.int32),
                retires=(kind == OUT_DONE).sum(dtype=torch.int32),
                fails=(kind == OUT_FAIL).sum(dtype=torch.int32),
                enqueues=(kind == OUT_SLEEP).sum(dtype=torch.int32))


def fused_step(proto, p, bank: Dict, *, cand_cyc, rot, addr, phase,
               acq_start, core: Dict, cyc: int, shift: int, lat: int,
               n: int, a: int, q_cap: int, cycles: int) -> Dict:
    """Arbitrate + protocol-update + histogram for one cycle's parked
    requests.  See ``ref.fused_step_ref`` for the argument contract; on
    CUDA tensors the bank tensors are updated in place."""
    kw = dict(cand_cyc=cand_cyc, rot=rot, addr=addr, phase=phase,
              acq_start=acq_start, core=core, cyc=cyc, shift=shift, lat=lat,
              n=n, a=a, q_cap=q_cap, cycles=cycles)
    dev = cand_cyc.device.type
    if dev == "cuda":
        return fused_step_cuda(proto, p, bank, **kw)
    if dev == "cpu":
        return fused_step_ref(proto, p, bank, **kw)
    raise ValueError(f"fused_step runs on cuda or cpu tensors, not {dev}")
