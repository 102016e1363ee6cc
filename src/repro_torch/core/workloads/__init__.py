"""Concurrent-algorithm workload plugins for the cycle-level engine (port).

Importing this package registers the workloads the port covers so far:

================  =====================================================
``rmw_loop``      the seed engine's work→RMW loop
``zipf_histogram`` histogram updates over a Zipf-skewed address stream
================  =====================================================

``ms_queue``, ``treiber_stack`` and ``barrier_phases`` are not ported
yet; asking for one fails at ``SimParams`` construction.
"""
from repro_torch.core.workloads import rmw_loop, zipf_histogram
from repro_torch.core.workloads.base import (ADDR_FIXED, ADDR_UNIFORM,
                                             ADDR_ZIPF, K_ATOMIC, K_BARRIER,
                                             Program, Workload, zipf_index)
from repro_torch.core.workloads.registry import get, names, register

__all__ = ["ADDR_FIXED", "ADDR_UNIFORM", "ADDR_ZIPF", "K_ATOMIC",
           "K_BARRIER", "Program", "Workload", "zipf_index",
           "get", "names", "register", "rmw_loop", "zipf_histogram"]
