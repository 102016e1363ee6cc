"""``rmw_loop`` — the seed engine's behaviour as a one-step program.

local work (``work`` cycles) → one atomic RMW on a uniform
pseudo-random address (``modify`` cycles between load and store) →
repeat.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.workloads.base import (ADDR_UNIFORM, K_ATOMIC, Program,
                                             Workload)
from repro_torch.core.workloads.registry import register


@register
class RmwLoop(Workload):
    name = "rmw_loop"

    def program(self, p) -> Program:
        return Program(kind=(K_ATOMIC,),
                       pre_mult=(1,), pre_add=(0,),
                       addr_mode=(ADDR_UNIFORM,), addr_arg=(0,),
                       mod_mult=(1,), mod_add=(0,))

    def check(self, p, res, trace=None):
        out = super().check(p, res, trace)
        # one-step program: completed ops == completed atomics, per core
        assert np.array_equal(np.asarray(res["ops"]), np.asarray(res["opc"]))
        return out
