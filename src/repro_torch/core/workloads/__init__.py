"""Concurrent-algorithm workload plugins for the cycle-level engine (port).

Importing this package registers every workload the reference has:

================  =====================================================
``rmw_loop``      the seed engine's work→RMW loop
``ms_queue``      enqueue/dequeue as two linked atomics on head/tail
``treiber_stack`` push/pop CAS pairs on one top-of-stack word
``zipf_histogram`` histogram updates over a Zipf-skewed address stream
``barrier_phases`` compute → barrier → compute (arXiv:2307.10248)
================  =====================================================

The engine runs every one of them, the Zipf stream at every skew.
"""
from repro_torch.core.workloads import (barrier_phases, ms_queue, rmw_loop,
                                        treiber_stack, zipf_histogram)
from repro_torch.core.workloads.base import (ADDR_FIXED, ADDR_UNIFORM,
                                             ADDR_ZIPF, K_ATOMIC, K_BARRIER,
                                             Program, Workload, zipf_index)
from repro_torch.core.workloads.registry import get, names, register

__all__ = ["ADDR_FIXED", "ADDR_UNIFORM", "ADDR_ZIPF", "K_ATOMIC",
           "K_BARRIER", "Program", "Workload", "zipf_index",
           "get", "names", "register",
           "barrier_phases", "ms_queue", "rmw_loop", "treiber_stack",
           "zipf_histogram"]
