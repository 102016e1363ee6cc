"""``repro_torch`` — the PyTorch/CUDA port of the LRSCwait reproduction.

A second package beside the JAX reference (``repro``), mirroring its
layout module for module.  It imports ``torch`` and ``numpy`` only.  The
public surface is :mod:`repro_torch.sync` (``run(Spec(...))``); the
engine is :mod:`repro_torch.core.sim`, whose per-cycle bank side runs in
the hand-written CUDA kernel :mod:`repro_torch.kernels.engine_step` on a
GPU and in its plain PyTorch version on the CPU.
"""
