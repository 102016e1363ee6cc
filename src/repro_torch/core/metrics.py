"""Single derivation layer for the paper's metric triple (port).

* **Throughput** — completed ops per cycle (plus the Fig. 5 worker
  streaming rate).
* **Fairness** — Jain's fairness index over the per-core completed-op
  distribution, the min/max rates and a NaN-safe span.
* **Latency** — per-atomic completion-latency percentiles (p50 / p95 /
  max) from the engine's geometric histogram (``lat_hist``,
  :data:`LAT_BINS` buckets, :data:`LAT_SUB` per octave) and the exact
  maximum (``lat_max``).
* **Energy** — pJ per completed op through the Table II-calibrated
  event-energy model (``core.costmodel``).

Everything but :func:`lat_bucket` is numpy on the host and equals the
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


def latency_percentiles(res: Dict[str, np.ndarray]) -> Dict[str, float]:
    """p50/p95/max completion latency for one result dict, from the
    always-on ``lat_hist``/``lat_max`` accumulators (≤ one bucket width
    of error; max is exact)."""
    lat_max = float(np.asarray(res.get("lat_max", 0)))
    hist = np.asarray(res.get("lat_hist", np.zeros(LAT_BINS, np.int64)))
    return {"lat_p50": _percentile_from_hist(hist, 0.50, lat_max),
            "lat_p95": _percentile_from_hist(hist, 0.95, lat_max),
            "lat_max": lat_max}


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
    return res
