"""Plain PyTorch version of the fused engine step.

``fused_step_ref`` composes the three bank-side stages the CUDA kernel
fuses — per-bank FIFO lexicographic-min arbitration over the parked
requests, the protocol's dense :meth:`Protocol.fused_access` bank update,
and the completion-latency histogram — as separate torch ops over the
full ``(a, n)`` extent.  It is the path ``ops.fused_step`` takes for CPU
tensors and the version the kernel is held against on the card.  It
returns new bank tensors and leaves its inputs untouched.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict

import torch

from repro_torch.core.metrics import LAT_BINS, lat_bucket
from repro_torch.core.protocols.base import (OUT_DONE, OUT_FAIL, P_ACQ, P_REL,
                                             FusedCtx)

#: int32 sentinel for "no request"
_BIG = 2**31 - 1


def _param_ns(p, lat):
    """FusedCtx.p namespace: the SimParams fields with ``lat`` swapped
    in."""
    vals = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    vals["lat"] = lat
    return SimpleNamespace(**vals)


def fused_step_ref(proto, p, bank: Dict, *, cand_cyc, rot, addr, phase,
                   acq_start, core: Dict, cyc: int, shift: int, lat: int,
                   n: int, a: int, q_cap: int, cycles: int) -> Dict:
    """One fused bank-side step, dense ``(a, n)``.

    Inputs: ``cand_cyc`` is the (n,) int32 arrival stamp with ``_BIG`` on
    the non-contending lanes; ``rot``/``addr``/``phase``/``acq_start``
    are the engine's (n,) int32 per-core arrays; ``core`` holds the (n,)
    fields ``proto.fused_core_fields`` names; ``cyc``/``shift``/``lat``
    are Python ints.

    Returns a dict with per-bank ``valid``/``win``/``kind``/``tmr``, the
    updated ``bank`` dict, the protocol's ``xset`` per-core writes, and
    the step's reduced stats as 0-d int32 tensors ``polls``, ``msgs``,
    ``lat_max`` and the (LAT_BINS,) int32 ``hist``.
    """
    dev = cand_cyc.device
    ba = torch.arange(a, dtype=torch.int32, device=dev)
    # ---- per-bank FIFO lexicographic (arrival stamp, rotated prio) min
    m = addr[None, :] == ba[:, None]                       # (a, n)
    c2 = torch.where(m, cand_cyc[None, :], _BIG)
    best_cyc = c2.amin(dim=1)                              # (a,)
    tie = (c2 == best_cyc[:, None]) & (c2 != _BIG)
    best_rot = torch.where(tie, rot[None, :], _BIG).amin(dim=1)
    valid = best_cyc != _BIG
    # decode the winning CORE from its rot (the rotation is affine);
    # torch.remainder is a floor-mod, like the reference's ``%``
    win = torch.where(valid, torch.remainder(best_rot - shift, n),
                      n).to(torch.int32)
    wcs = win.clamp(max=n - 1)                             # gather-safe

    # ---- protocol dense bank update
    phase_w = phase[wcs]
    acq_b = valid & (phase_w == P_ACQ)
    rel_b = valid & (phase_w == P_REL)
    fx = FusedCtx(p=_param_ns(p, lat), n=n, a=a, q_cap=q_cap,
                  win=win, acq_b=acq_b, rel_b=rel_b,
                  core={f: v[wcs] for f, v in core.items()})
    bank, fo = proto.fused_access(fx, bank)

    # ---- completion-latency histogram (bank-side)
    done_cyc = cyc + fo.tmr.clamp(min=1)
    fut = (fo.kind == OUT_DONE) & (done_cyc < cycles)
    lat_b = done_cyc - acq_start[wcs]
    hist = torch.zeros((LAT_BINS,), dtype=torch.int32, device=dev)
    hist.index_add_(0, lat_bucket(lat_b), fut.to(torch.int32))
    lat_max = torch.where(fut, lat_b, 0).amax().to(torch.int32)

    polls = (fo.kind == OUT_FAIL).sum(dtype=torch.int32)
    msgs = (fo.msgs.sum(dtype=torch.int32) if fo.msgs is not None
            else torch.zeros((), dtype=torch.int32, device=dev))
    return dict(valid=valid, win=win, kind=fo.kind, tmr=fo.tmr,
                bank=bank, xset=dict(fo.xset),
                polls=polls, msgs=msgs, hist=hist, lat_max=lat_max)
