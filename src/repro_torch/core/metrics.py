"""Single derivation layer for the paper's metric triple (port).

* **Throughput** — completed ops per cycle (plus the Fig. 5 worker
  streaming rate).
* **Fairness** — Jain's fairness index over the per-core completed-op
  distribution, the min/max rates and a NaN-safe span.
* **Latency** — per-atomic completion-latency percentiles (p50 / p95 /
  max): exact from the recorded waits of a ``record_trace`` run
  (``trace_wait``), else from the engine's geometric histogram
  (``lat_hist``, :data:`LAT_BINS` buckets, :data:`LAT_SUB` per octave);
  the maximum (``lat_max``) is exact either way.  The recorded waits
  also fold onto the histogram's bins through the ``colibri_scatter``
  kernel (:func:`trace_latency_hist`).
* **Energy** — pJ per completed op through the Table II-calibrated
  event-energy model (``core.costmodel``).

Everything but :func:`lat_bucket` and the commit of
:func:`trace_latency_hist` is numpy on the host and equals the
reference's derivation exactly; :func:`lat_bucket` is the engine's
on-device bucketing.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import costmodel

#: latency histogram geometry: bucket(v) = floor(LAT_SUB * log2(v + 1)),
#: clipped to [0, LAT_BINS).  64 buckets at 4 sub-buckets per octave
#: cover latencies up to 2^16 cycles at ≤ 2^(1/4) ≈ 1.19× bucket width.
LAT_BINS = 64
LAT_SUB = 4

#: the bucket geometry as integer thresholds: bucket(v) is the largest k
#: with ``LAT_THRESHOLDS[k] <= v``.  Each entry is the smallest latency
#: the reference's float32 ``floor(4 * log2(v + 1))`` puts in bucket k or
#: above, so no ``log2`` runs anywhere in the port.  The table keeps the
#: reference's float32 rounding: XLA's ``log2`` lands 8191 and 32767
#: one bucket low (51 and 59), which an exact or another library's
#: ``log2`` would not (tests/test_torch_primitives.py re-derives every
#: entry from the reference over [0, 2^20)).
LAT_THRESHOLDS = (
    0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 5, 6, 7, 9, 11, 13,
    15, 19, 22, 26, 31, 38, 45, 53, 63, 76, 90, 107, 127, 152, 181, 215,
    255, 304, 362, 430, 511, 608, 724, 861, 1023, 1217, 1448, 1722, 2047,
    2435, 2896, 3444, 4095, 4870, 5792, 6888, 8192, 9741, 11585, 13777,
    16383, 19483, 23170, 27554, 32768, 38967, 46340, 55108)

#: engine stat totals the energy model bills (see costmodel.fit_energy)
ENERGY_STAT_KEYS = ("msgs", "bank_ops", "active_cyc", "sleep_cyc",
                    "backoff_cyc", "bar_cyc")

#: the triple every result dict must carry
METRIC_TRIPLE = ("jain_fairness", "lat_p95", "energy_pj_per_op")


@functools.lru_cache(maxsize=None)
def _thresholds(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(LAT_THRESHOLDS, dtype=dtype, device=device)


def lat_bucket(v: torch.Tensor) -> torch.Tensor:
    """Latency-histogram bucket of each int32 latency ``v``: the largest
    k with ``LAT_THRESHOLDS[k] <= v`` (0 below the first threshold)."""
    thr = _thresholds(v.dtype, v.device)
    k = torch.searchsorted(thr, v.contiguous(), right=True) - 1
    return k.clamp_(0, LAT_BINS - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# Fairness
# ---------------------------------------------------------------------------

def jain_fairness(ops) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` over per-core ops; 0.0
    for an empty slice or when nothing completed."""
    x = np.asarray(ops, dtype=np.float64).ravel()
    if x.size == 0:
        return 0.0
    sq = float((x * x).sum())
    if sq == 0.0:
        return 0.0
    return float(x.sum()) ** 2 / (x.size * sq)


def fairness_span(ops) -> float:
    """NaN-safe fastest/slowest per-core ops ratio: ``inf`` when some
    core starved while another made progress, 0.0 when nothing
    completed at all (or the slice is empty)."""
    x = np.asarray(ops, dtype=np.float64).ravel()
    if x.size == 0:
        return 0.0
    lo, hi = float(x.min()), float(x.max())
    if lo <= 0.0:
        return 0.0 if hi <= 0.0 else math.inf
    return hi / lo


# ---------------------------------------------------------------------------
# Latency percentiles
# ---------------------------------------------------------------------------

def bucket_rep(i) -> np.ndarray:
    """Representative latency for histogram bucket ``i`` (geometric mean
    of the bucket's value range ``[2^(i/S) - 1, 2^((i+1)/S) - 1)``)."""
    return np.power(2.0, (np.asarray(i, np.float64) + 0.5) / LAT_SUB) - 1.0


def _percentile_from_hist(hist: np.ndarray, q: float,
                          lat_max: float) -> float:
    """Inverted-CDF percentile from the geometric histogram, clamped to
    the exact observed maximum."""
    cum = np.cumsum(hist.astype(np.int64))
    total = int(cum[-1]) if cum.size else 0
    if total == 0:
        return 0.0
    want = max(int(math.ceil(q * total)), 1)
    idx = int(np.searchsorted(cum, want))
    return float(min(bucket_rep(idx), lat_max))


def _recorded_waits(res: Dict[str, np.ndarray]) -> np.ndarray:
    """The per-completion waits of a ``record_trace`` run (``trace_wait``
    holds -1 where no core retired)."""
    tw = np.asarray(res["trace_wait"])
    return tw[tw >= 0]


def _percentile_from_waits(waits: np.ndarray, q: float) -> float:
    """Exact inverted-CDF percentile (the value at rank ⌈q·k⌉) over the
    recorded per-completion waits."""
    if waits.size == 0:
        return 0.0
    s = np.sort(waits)
    return float(s[max(int(math.ceil(q * s.size)), 1) - 1])


def trace_latency_hist(res: Dict[str, np.ndarray], use_kernel: bool = True,
                       device=None) -> np.ndarray:
    """Exact-trace completion-latency histogram on the engine's
    geometric bins: the recorded per-completion waits
    (``record_trace=True``) folded onto the ``LAT_BINS``/``LAT_SUB``
    geometry of ``lat_hist``.

    The waits are bucketed as the reference's ``trace_latency_hist``
    buckets them — numpy's float32 ``log2`` on the host, which puts
    8191 and 32767 in buckets 52 and 60, where the engine's
    ``lat_bucket`` (XLA's rounding) puts them in 51 and 59 — so the
    result equals the reference's.  The commit goes through the
    ``colibri_scatter`` kernel on ``device`` (``None`` means ``"cuda"``,
    and raises without a GPU; the CPU runs its plain version);
    ``use_kernel=False`` uses a plain ``np.bincount``.
    """
    waits = _recorded_waits(res)
    if waits.size == 0:
        return np.zeros((LAT_BINS,), np.int32)
    bkt = np.clip((LAT_SUB * np.log2(
        waits.astype(np.float32) + np.float32(1.0))).astype(np.int32),
        0, LAT_BINS - 1)
    if not use_kernel:
        return np.bincount(bkt, minlength=LAT_BINS).astype(np.int32)
    from repro_torch.core.sim import resolve_device
    from repro_torch.kernels.colibri_scatter import colibri_histogram
    keys = torch.from_numpy(bkt).to(resolve_device(device))
    return colibri_histogram(keys, LAT_BINS).cpu().numpy()


def latency_percentiles(res: Dict[str, np.ndarray]) -> Dict[str, float]:
    """p50/p95/max completion latency for one result dict: exact from
    the recorded waits when a trace was recorded (``trace_wait``), else
    from the always-on ``lat_hist``/``lat_max`` accumulators (≤ one
    bucket width of error); max is exact either way."""
    lat_max = float(np.asarray(res.get("lat_max", 0)))
    if "trace_wait" in res:
        waits = _recorded_waits(res)
        out = {"lat_p50": _percentile_from_waits(waits, 0.50),
               "lat_p95": _percentile_from_waits(waits, 0.95)}
    else:
        hist = np.asarray(res.get("lat_hist",
                                  np.zeros(LAT_BINS, np.int64)))
        out = {"lat_p50": _percentile_from_hist(hist, 0.50, lat_max),
               "lat_p95": _percentile_from_hist(hist, 0.95, lat_max)}
    out["lat_max"] = lat_max
    return out


# ---------------------------------------------------------------------------
# Energy
# ---------------------------------------------------------------------------

def energy_stats(res: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The billable stat totals of one result dict, as plain floats."""
    s = {k: float(np.asarray(res[k])) for k in ENERGY_STAT_KEYS}
    s["ops"] = float(np.asarray(res["ops"]).sum())
    if "hops" in res:
        s["hops"] = float(np.asarray(res["hops"]))
    return s


# ---------------------------------------------------------------------------
# The derivation layer
# ---------------------------------------------------------------------------

def attach(res: Dict[str, np.ndarray], n_workers: int, cycles: int,
           fit: Optional[costmodel.EnergyFit] = None
           ) -> Dict[str, np.ndarray]:
    """Attach the full paper-metric set to a raw engine result dict
    (numpy arrays): throughput and worker rate, the fairness family,
    latency percentiles, and pJ per op through ``fit`` (default: the
    Table II calibration)."""
    ops = res["ops"][n_workers:] if n_workers else res["ops"]
    res["throughput"] = float(ops.sum()) / cycles if ops.size else 0.0
    res["fairness_min"] = float(ops.min()) / cycles if ops.size else 0.0
    res["fairness_max"] = float(ops.max()) / cycles if ops.size else 0.0
    res["jain_fairness"] = jain_fairness(ops)
    res["fairness_span"] = fairness_span(ops)
    res.update(latency_percentiles(res))
    stats = energy_stats(res)
    res["energy_pj_per_op"] = (
        costmodel.energy_per_op(stats, fit or costmodel.default_fit())
        if stats["ops"] > 0 else 0.0)
    if n_workers:
        w = res["w_served"][:n_workers]
        res["worker_rate"] = (float(w.sum()) / cycles / n_workers
                              if w.size else 0.0)
    if "dead_mask" in res:
        # graceful-degradation metrics: the engine emits these keys only
        # when a FaultPlan is enabled
        dm = np.asarray(res["dead_mask"])[n_workers:] if n_workers \
            else np.asarray(res["dead_mask"])
        res["stalled_cores"] = int(np.asarray(res["dead_mask"]).sum())
        surv = ops[~dm] if dm.size else ops
        res["survivor_throughput"] = (float(surv.sum()) / cycles
                                      if surv.size else 0.0)
        res["survivor_jain"] = jain_fairness(surv)
        res["faults_injected"] = int(np.asarray(res["faults_injected"]))
        res["recoveries"] = int(np.asarray(res.get("recoveries", 0)))
        # liveness verdict: the forward-progress watchdog never flagged
        # a halt
        res["halt_cyc"] = int(np.asarray(res["halt_cyc"]))
        res["progress_ok"] = bool(res["halt_cyc"] < 0)
    return res
