"""``treiber_stack`` — Treiber-stack traffic: push/pop CAS pairs on one
top-of-stack word.

Every op is a push RMW on the ``top`` pointer (address 0) followed, one
dependent-load gap later, by a pop RMW on the same word: the classic
single-hot-word concurrent object, maximally contended (unlike
``ms_queue`` there is no head/tail split to spread load over banks).

``check`` validates per-core LIFO order from the completion trace:
each core strictly alternates push→pop, so every pop removes that
core's most recent un-popped push — the per-core LIFO law the stack
guarantees without tracking values.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.workloads.base import (ADDR_FIXED, K_ATOMIC, Program,
                                             Workload)
from repro_torch.core.workloads.registry import register

TOP = 0
PUSH, POP = 0, 1
DEP_GAP = 2


@register
class TreiberStack(Workload):
    name = "treiber_stack"
    scenario = {"n_addrs": 1}                    # one top-of-stack word

    def program(self, p) -> Program:
        return Program(kind=(K_ATOMIC, K_ATOMIC),
                       pre_mult=(1, 0), pre_add=(0, DEP_GAP),
                       addr_mode=(ADDR_FIXED, ADDR_FIXED),
                       addr_arg=(TOP, TOP),
                       mod_mult=(1, 1), mod_add=(0, 0))

    def check(self, p, res, trace=None):
        out = super().check(p, res, trace)
        if trace is None:
            return out
        trace = np.asarray(trace)
        pushes = int((trace == PUSH).sum())
        pops = int((trace == POP).sum())
        assert pops <= pushes, "more pops than pushes"
        # per-core LIFO: strict push→pop alternation means each pop
        # matches the core's latest outstanding push
        for c, seq in self._per_core_steps(trace):
            want = np.arange(len(seq)) % 2
            assert np.array_equal(seq, want), f"core {c} broke LIFO order"
        out["pushes"], out["pops"] = pushes, pops
        return out
