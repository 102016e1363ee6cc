"""Workload plugin interface for the cycle-level engine (``core.sim``).

A *workload* owns what each core *runs*: a small per-core **program** of
micro-ops that the engine interprets with a per-core program counter.

A :class:`Program` is a static table of ``length`` micro-op steps.  Each
step is an atomic phase::

    <pre_mult*work + pre_add cycles of local work>
    ATOMIC(addr_mode, addr_arg)          # kind = K_ATOMIC
        with mod_mult*modify + mod_add cycles between load and store
  or
    BARRIER-arrival atomic, then wait    # kind = K_BARRIER

Address streams:

=============  =========================================================
ADDR_UNIFORM   counter-hash uniform over ``n_addrs``
ADDR_FIXED     ``addr_arg % n_addrs``
ADDR_ZIPF      bounded power-law over ``n_addrs`` with skew
               ``zipf_skew/100`` (:func:`zipf_index`)
=============  =========================================================

Completing the last step wraps the program counter and counts one
completed *op*.  ``check`` validates a result dict host-side (numpy).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# micro-op kinds
K_ATOMIC, K_BARRIER = 0, 1
# address-stream modes
ADDR_UNIFORM, ADDR_FIXED, ADDR_ZIPF = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Program:
    """Static per-core micro-op table (tuples of ints, one entry per
    step)."""
    kind: Tuple[int, ...]
    pre_mult: Tuple[int, ...]       # local work = pre_mult*work + pre_add
    pre_add: Tuple[int, ...]
    addr_mode: Tuple[int, ...]
    addr_arg: Tuple[int, ...]
    mod_mult: Tuple[int, ...]       # modify  = mod_mult*modify + mod_add
    mod_add: Tuple[int, ...]

    def __post_init__(self):
        L = len(self.kind)
        if L < 1:
            raise ValueError("empty program")
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if len(v) != L:
                raise ValueError(f"field {f.name} has length {len(v)} != {L}")
        for k, m in zip(self.kind, self.addr_mode):
            if k not in (K_ATOMIC, K_BARRIER):
                raise ValueError(f"unknown micro-op kind {k}")
            if k == K_BARRIER and m != ADDR_FIXED:
                raise ValueError("barrier steps need a FIXED address")
            if m not in (ADDR_UNIFORM, ADDR_FIXED, ADDR_ZIPF):
                raise ValueError(f"unknown address mode {m}")

    @property
    def length(self) -> int:
        return len(self.kind)

    def tables(self) -> Dict[str, np.ndarray]:
        """The table as int32 numpy arrays (the engine folds them)."""
        return {f.name: np.asarray(getattr(self, f.name), np.int32)
                for f in dataclasses.fields(self)}


def zipf_index(h24: torch.Tensor, n_addrs: int, skew_pct: int
               ) -> torch.Tensor:
    """Map a 24-bit hash to a Zipf-like address in ``[0, n_addrs)``.

    Inverse CDF of the bounded continuous power law with density
    ∝ x^(-s) on [1, n+1): ``x = (1 + u*((n+1)^(1-s) - 1))^(1/(1-s))``
    with the log-uniform limit ``(n+1)^u`` near s = 1; address =
    ``floor(x) - 1``.  ``skew_pct`` is ``100*s``.

    The float32 arithmetic follows the reference op for op.  The
    scalar factors (``n_addrs``/``skew_pct`` are Python ints here) are
    folded on the host in float32; at ``skew_pct=0`` every one of them
    is exact, which is what makes the stream bit-identical to the
    reference's there.
    """
    u = h24.to(torch.float32) * float(np.float32(1.0 / (1 << 24)))
    top, c, inv = zipf_factors(n_addrs, skew_pct)
    if c is None:
        x = torch.pow(top, u)
    else:
        x = u * c + 1.0
        if inv != 1.0:
            x = torch.pow(x, inv)
    return (torch.floor(x).to(torch.int32) - 1).clamp_(0, n_addrs - 1)


def zipf_factors(n_addrs: int, skew_pct: int):
    """``zipf_index``'s scalar factors, folded in float32 on the host:
    ``(top, c, inv)`` with ``x = (u*c + 1)^inv``, or ``c = None`` in the
    log-uniform limit ``x = top^u`` (skew within 1e-3 of 1).  At skew 0,
    ``c`` is ``n_addrs`` and ``inv`` is 1: the stream is ``u*c + 1``,
    two rounded float32 ops."""
    top = np.float32(n_addrs) + np.float32(1.0)
    s = np.float32(skew_pct) * np.float32(0.01)
    om = np.float32(1.0) - s
    if abs(om) < 1e-3:
        return float(top), None, None
    c = float(np.float32(top ** om) - np.float32(1.0))
    return float(top), c, float(np.float32(1.0) / om)


class Workload:
    """Base workload plugin.  Subclasses compile a :class:`Program` from
    the static ``SimParams`` and validate results host-side."""

    name: str = ""
    #: smallest ``n_addrs`` the program needs to keep its fixed
    #: addresses distinct
    min_addrs: int = 1
    #: canonical ``SimParams`` overrides for this workload's scenario
    scenario: Dict[str, int] = {}

    def program(self, p) -> Program:
        raise NotImplementedError

    # ---- host-side conservation laws ----
    def check(self, p, res: Dict[str, Any],
              trace: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Assert this workload's invariants on a result dict: each
        completed atomic retired on exactly one address, and the
        latency histogram carries exactly the retired-atomic count."""
        addr_ops = np.asarray(res["addr_ops"])
        atomics = int(np.asarray(res["opc"]).sum())
        assert int(addr_ops.sum()) == atomics, \
            f"address histogram mass {int(addr_ops.sum())} != {atomics}"
        if "lat_hist" in res:
            lat_mass = int(np.asarray(res["lat_hist"]).sum())
            assert lat_mass == atomics, \
                f"latency histogram mass {lat_mass} != {atomics}"
        return {"atomics": atomics, "ops": int(np.asarray(res["ops"]).sum())}
