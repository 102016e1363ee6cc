"""``zipf_histogram`` — histogram updates over a skewed address stream.

Same one-atomic-per-op shape as ``rmw_loop``, but the address stream is
a bounded power law (:func:`~repro_torch.core.workloads.base.zipf_index`)
with skew ``SimParams.zipf_skew / 100`` instead of the uniform counter
hash.  ``zipf_skew=0`` is the exact uniform limit over ``n_addrs`` bins
(the Fig. 3 histogram scenario); a skewed stream is the reference's bit
for bit, in a single run's and a sweep's form.  ``check`` asserts mass
conservation and, for skewed streams, that the hot bin carries at least
its uniform share.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.workloads.base import (ADDR_ZIPF, K_ATOMIC, Program,
                                             Workload)
from repro_torch.core.workloads.registry import register


@register
class ZipfHistogram(Workload):
    name = "zipf_histogram"
    scenario = {"n_addrs": 64, "zipf_skew": 100}

    def program(self, p) -> Program:
        return Program(kind=(K_ATOMIC,),
                       pre_mult=(1,), pre_add=(0,),
                       addr_mode=(ADDR_ZIPF,), addr_arg=(0,),
                       mod_mult=(1,), mod_add=(0,))

    def check(self, p, res, trace=None):
        out = super().check(p, res, trace)       # bin totals == atomics
        addr_ops = np.asarray(res["addr_ops"])[:p.n_addrs]
        total = max(int(addr_ops.sum()), 1)
        out["hot_share"] = float(addr_ops.max()) / total
        if p.zipf_skew > 0 and p.n_addrs > 1 and total > 16:
            assert out["hot_share"] >= 1.0 / p.n_addrs, \
                "skewed stream lost its hot bin"
        return out
