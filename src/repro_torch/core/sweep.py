"""Batched parameter sweeps: many engine runs in one launch (port).

The port of ``repro.core.sweep``.  The reference groups configurations
by their static fingerprint and runs each group through one
``jax.vmap``-ed compilation; on the card a run is one thread block of
the ``engine_run`` kernel, so a batch is a grid of run blocks
(``core.sim.simulate_batch`` → ``kernels.engine_step.run_cuda_batch``).
The kernel's block size depends only on ``n_cores``, and every other
field is a per-run value in its parameter words, so ONE launch may hold
every point of one core count, whatever its protocol, cycles, queue
capacity, trace or telemetry switches.

Entry points: :func:`sweep_params` (list in, input-order list out) and
:func:`sweep_iter` (generator yielding points as chunks come back) —
the machinery behind ``repro_torch.sync.Study.run()`` / ``.stream()``;
:func:`sweep` / :func:`sweep_grid` are deprecated legacy shims.

Executor shape:

* **Chunking** — each launch group is split into ``max_batch``-point
  chunks (default 256, ``REPRO_SWEEP_MAX_BATCH`` read at each call), the
  hard ceiling on points per launch: a traced point carries
  ``(cycles, n)`` traces.
* **Overlapped dispatch** — CUDA launches are asynchronous: a chunk is
  launched and its one device→host copy queued behind it, and up to 4
  chunks are in flight, so the next chunk's host packing overlaps the
  current chunk's run; the copy is where a chunk drains.
* **One transfer per chunk** — a launch's outputs are views of one flat
  device buffer, copied to the host in one copy (:func:`_to_host`).

Every point runs with its banks at the power-of-two bucket of its
``n_addrs`` (``_bucket_a``) and its addresses hashed over the live
count, as in the reference: a swept point equals its single run on
every key, the per-bank arrays padded with the initial bank state —
except where the reference's sweep differs from its single run too (a
skewed Zipf stream's sweep form; bank-stall victims drawn over the
bucket).

Multi-device placement (the reference's ``NamedSharding``) is not
ported: a sweep runs on the one ``device`` it is given.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import sim as _sim
from repro_torch.core.sim import (DYN_FIELDS, SimParams, _bucket_a,
                                  derive_metrics)

#: the reference's fingerprint fields (``repro.core.sweep.STATIC_FIELDS``):
#: with DYN_FIELDS they cover SimParams.  The port's launch groups are
#: coarser (``_launch_key``)
STATIC_FIELDS = ("protocol", "workload", "n_cores", "cycles", "q_slots",
                 "n_groups", "record_trace", "unroll", "backend",
                 "telemetry_windows", "faults", "topology", "clusters")

#: default ceiling on points per launch (``REPRO_SWEEP_MAX_BATCH``
#: overrides — read at each call, so setting it after import still
#: takes effect)
DEFAULT_MAX_BATCH = 256

#: chunks launched ahead of the one being copied back
_WINDOW = 4


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """The on-disk cache of the port's compiled kernels: the CUDA
    libraries are built once per source (by content hash) into
    ``kernels._build.build_dir()`` and loaded from there on every later
    run, so there is nothing to switch on.  Makes the directory and
    returns it.  ``path``, the reference's cache location, may only name
    that directory (``ValueError`` otherwise)."""
    from repro_torch.kernels import _build
    where = _build.build_dir()
    if path is not None and os.path.abspath(path) != os.path.abspath(where):
        raise ValueError(
            f"the port caches its CUDA libraries in {where}, not {path}")
    where.mkdir(parents=True, exist_ok=True)
    return str(where)


def _static_key(p: SimParams):
    """The reference's compile fingerprint of ``p``."""
    return (tuple(getattr(p, f) for f in STATIC_FIELDS)
            + (_bucket_a(p.n_addrs),))


def _launch_key(p: SimParams) -> int:
    """What must match for points to share one launch: the core count,
    which sets the kernel's instance and block size."""
    return p.n_cores


#: headline metrics screened for NaN/inf per point — ``fairness_span``
#: is deliberately absent (inf legitimately encodes a starved core)
_HEADLINE_KEYS = ("throughput", "jain_fairness", "energy_pj_per_op")


def _finite_metrics(res) -> bool:
    for k in _HEADLINE_KEYS:
        v = res.get(k)
        if v is not None and not math.isfinite(float(v)):
            return False
    return True


def _sweep_group(chunk: Sequence[SimParams], device, started=None
                 ) -> List[Dict[str, torch.Tensor]]:
    """Launch one chunk (points of one launch group): its result dicts
    on ``device``, not yet waited for; ``started`` (a CUDA event) is
    recorded before the card's work."""
    return _sim.simulate_batch(chunk, device, started)


def _refuse_on_card(p: SimParams) -> None:
    """Raise ``NotImplementedError`` if the card's run kernel does not
    take the point ``p`` (``engine_step.kernel.refuse_on_card``)."""
    from repro_torch.core import protocols, workloads
    from repro_torch.kernels.engine_step import kernel as es_kernel
    es_kernel.refuse_on_card(p, protocols.get(p.protocol),
                             workloads.get(p.workload).program(p))


def _to_host(outs: List[Dict[str, torch.Tensor]], started=None):
    """Queue a chunk's ONE device→host copy (``core.sim.to_host``, into
    pinned memory, behind the launch); ``started`` is the CUDA event
    recorded before the chunk's card work."""
    return _sim.to_host(outs, started, pinned=True)


def _library_load():
    """(seconds, persistent-cache hit) of loading the engine library in
    this process, or None when it is loaded already."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.engine_step import kernel as es_kernel
    if es_kernel._run_library.cache_info().currsize:
        return None
    built = _build.built("engine_step")
    t0 = time.perf_counter()
    es_kernel._run_library()
    return time.perf_counter() - t0, built


def sweep_iter(configs: Sequence[SimParams],
               max_batch: Optional[int] = None, energy_fit=None,
               report=None, device=None
               ) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """Streaming sweep on ``device`` (default ``"cuda"``; ``"cpu"`` runs
    the plain loop): yield ``(index, result)`` pairs as chunks come
    back, in chunk-completion order (launch groups in first-appearance
    order, chunks in order within a group) — NOT input order.  Each
    result dict is what :func:`sweep_params` returns for that config,
    metric triple included.  This is the engine behind
    ``repro_torch.sync.Study.stream()``.

    ``report`` (a :class:`repro_torch.obs.RunReport`) records one chunk
    record per launch; when None, the ambient report of an enclosing
    ``repro_torch.obs.collect()`` block is used.  Instrumentation never
    changes results.

    **Failure isolation** (the reference's ladder): a chunk whose launch
    raises on the host (its packing, or a launch error code) is re-run
    through a bisection ladder — halves batched, a failing half split
    again, a failing single point re-run solo — so every healthy point
    still yields its normal result and only the minimal failing set
    yields ``{"error": "ExcType: message", "error_stage": ...}``
    (``Result.ok == False``).  A point whose metric derivation raises,
    or whose headline metrics are non-finite, gets one solo retry, then
    an error record.  A fault on the card while a chunk runs surfaces
    when its copy is waited for and is raised, not isolated: a sticky
    CUDA error poisons the context, so re-running halves cannot isolate
    it.  Refusals (``NotImplementedError``: a point the card's kernel
    does not take, ``engine_step.kernel.refuse_on_card``) are raised on
    the card while the grid is planned, before its first launch, and
    pass through the fence: a refusal is not a failure of one point.
    """
    if max_batch is None:
        max_batch = int(os.environ.get("REPRO_SWEEP_MAX_BATCH",
                                       DEFAULT_MAX_BATCH))
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
    dev = _sim.resolve_device(device)
    on_card = dev.type == "cuda"
    if report is None:
        from repro_torch.obs import runreport as _runreport
        report = _runreport.current()            # ambient collect(), or None
    if report is not None and configs:
        report.note_env("cuda" if on_card else "cpu", max_batch, dev)
    groups: Dict[int, List[int]] = {}
    for i, c in enumerate(configs):
        if on_card:
            _refuse_on_card(c)
        groups.setdefault(_launch_key(c), []).append(i)

    def solo(i, stage):
        """Last rung of the isolation ladder: ONE point alone; a failure
        here becomes its structured error record."""
        c = configs[i]
        try:
            outs = _sweep_group([c], dev)
        except NotImplementedError:
            raise
        except Exception as e:       # noqa: BLE001 — fenced by design
            return {"error": f"{type(e).__name__}: {e}",
                    "error_stage": stage}
        res = _to_host(outs).wait()[0]
        try:
            m = derive_metrics(res, min(c.n_workers, c.n_cores), c.cycles,
                               energy_fit=energy_fit)
        except Exception as e:       # noqa: BLE001 — fenced by design
            return {"error": f"{type(e).__name__}: {e}",
                    "error_stage": "metrics"}
        if not _finite_metrics(m):
            return {"error": "non-finite headline metrics "
                             "(throughput/jain/energy)",
                    "error_stage": "nonfinite"}
        return m

    def derive_checked(i, res):
        """Per-point metric derivation with the solo-retry fallback."""
        c = configs[i]
        try:
            m = derive_metrics(res, min(c.n_workers, c.n_cores), c.cycles,
                               energy_fit=energy_fit)
        except Exception:            # noqa: BLE001 — fenced by design
            return solo(i, "metrics")
        if not _finite_metrics(m):
            return solo(i, "nonfinite")
        return m

    def isolate(part, stage):
        """Bisected retry of a chunk whose launch raised: halves re-run
        batched, a failing half recurses, a single point falls through
        to :func:`solo` — healthy points keep their normal results."""
        if len(part) == 1:
            yield part[0], solo(part[0], stage)
            return
        mid = len(part) // 2
        for half in (part[:mid], part[mid:]):
            try:
                outs = _sweep_group([configs[i] for i in half], dev)
            except NotImplementedError:
                raise
            except Exception:        # noqa: BLE001 — fenced by design
                yield from isolate(half, stage)
                continue
            for i, res in zip(half, _to_host(outs).wait()):
                yield i, derive_checked(i, res)

    def materialize(part, fetch, rec):
        res = fetch.wait()           # the chunk drains here
        if rec is not None:
            rec.execute_s = fetch.seconds()
        for i, r in zip(part, res):
            yield i, derive_checked(i, r)

    pending: List[tuple] = []                    # launched, not fetched
    for idxs in groups.values():
        for lo in range(0, len(idxs), max_batch):
            part = idxs[lo:lo + max_batch]
            load = _library_load() if on_card else None
            started = None           # recorded once the host has packed
            if on_card and report is not None:
                started = torch.cuda.Event(enable_timing=True)
            try:
                outs = _sweep_group([configs[i] for i in part], dev, started)
            except NotImplementedError:
                raise
            except Exception:        # noqa: BLE001 — fenced by design
                yield from isolate(part, "dispatch")
                continue
            fetch = _to_host(outs, started)
            rec = None
            if report is not None:
                c0 = configs[part[0]]
                names = sorted({configs[i].protocol for i in part})
                wls = sorted({configs[i].workload for i in part})
                report.record_chunk(
                    label=(f"{'+'.join(names)}/{'+'.join(wls)} "
                           f"{c0.n_cores}c"),
                    points=len(part), batch=len(part),
                    compile_s=load[0] if load else 0.0, execute_s=0.0,
                    compiled=load is not None)
                if load is not None and load[1]:
                    report.persistent_cache_hits += 1
                rec = report.chunks[-1]
            pending.append((part, fetch, rec))
            if len(pending) >= _WINDOW:
                yield from materialize(*pending.pop(0))
    for part, fetch, rec in pending:
        yield from materialize(part, fetch, rec)


def sweep_params(configs: Sequence[SimParams],
                 max_batch: Optional[int] = None, energy_fit=None,
                 report=None, device=None) -> List[Dict[str, np.ndarray]]:
    """Run every configuration on ``device`` (default ``"cuda"``);
    returns one result dict per config, in input order: the keys and
    values of ``sim.execute`` with the per-bank arrays padded to the
    bucket (``_bucket_a``), the paper's metric triple attached per point.
    ``energy_fit`` overrides the frozen Table II calibration.

    Internal engine entry point: the supported public surface is
    :class:`repro_torch.sync.Study`, which wraps each point in a typed
    :class:`repro_torch.sync.Result`.
    """
    results: List = [None] * len(configs)
    for i, res in sweep_iter(configs, max_batch=max_batch,
                             energy_fit=energy_fit, report=report,
                             device=device):
        results[i] = res
    return results


def sweep(configs: Sequence[SimParams], max_batch: Optional[int] = None,
          energy_fit=None, device=None) -> List[Dict[str, np.ndarray]]:
    """Deprecated legacy entry point — use ``repro_torch.sync.Study``."""
    warnings.warn(
        "repro_torch.core.sweep.sweep() is deprecated; use "
        "repro_torch.sync.Study (Study.from_specs(...).run() / .stream()) "
        "which returns typed Results.", DeprecationWarning, stacklevel=2)
    return sweep_params(configs, max_batch=max_batch, energy_fit=energy_fit,
                        device=device)


def sweep_grid(base: SimParams, max_batch: Optional[int] = None,
               energy_fit=None, device=None, **axes: Sequence
               ) -> List[Dict[str, np.ndarray]]:
    """Deprecated legacy entry point — use
    ``repro_torch.sync.Study(base).grid(...)``.

    Cartesian sweep: ``sweep_grid(base, n_addrs=(1, 16), seed=(0, 1))``
    runs every combination (last axis fastest) and returns results plus
    a ``_config`` entry recording each point's SimParams."""
    warnings.warn(
        "repro_torch.core.sweep.sweep_grid() is deprecated; use "
        "repro_torch.sync.Study(base_spec).grid(...).run() / .stream().",
        DeprecationWarning, stacklevel=2)
    for name in axes:
        if name not in DYN_FIELDS:
            raise ValueError(f"{name!r} is not sweepable; axes: {DYN_FIELDS}")
    points = [base]
    for name, values in axes.items():
        points = [dataclasses.replace(pt, **{name: v})
                  for pt in points for v in values]
    results = sweep_params(points, max_batch=max_batch,
                           energy_fit=energy_fit, device=device)
    for pt, res in zip(points, results):
        res["_config"] = pt
    return results
