"""Area and energy models calibrated to the paper's Tables I and II.

Silicon numbers cannot be re-derived by a simulator; we model them structurally
(component counts × per-component costs) and fit the per-component costs to
the published rows, reporting residuals.  A numpy-only copy of the
reference model: ``CALIBRATED_ENERGY`` is the same frozen calibration.

Table I (area, kGE, MemPool tile = 4 cores + 16 banks):
    tile 691 | +LRSCwait_1 790 | +LRSCwait_8 865 |
    +Colibri 1/2/4/8 addr: 732 / 750 / 761 / 802

Table II (energy @ highest contention):
    AMO 29 pJ/op | Colibri 124 | LRSC 884 | AMO lock 1092
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

TILE_CORES = 4
TILE_BANKS = 16
TILE_BASE_KGE = 691.0

PAPER_AREA = {  # design -> (param, kGE)
    "lrscwait_1": (1, 790.0),
    "lrscwait_8": (8, 865.0),
    "colibri_1": (1, 732.0),
    "colibri_2": (2, 750.0),
    "colibri_4": (4, 761.0),
    "colibri_8": (8, 802.0),
}

PAPER_ENERGY = {  # protocol -> pJ/op at highest contention
    "amo": 29.0, "colibri": 124.0, "lrsc": 884.0, "amo_lock": 1092.0,
}


# ---------------------------------------------------------------------------
# Area model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AreaFit:
    lrscwait_ctrl: float      # per-bank controller (kGE)
    lrscwait_slot: float      # per queue slot per bank
    colibri_ctrl: float       # per-bank head/tail controller
    colibri_addr: float       # per additional address queue per bank
    qnode: float              # per-core Qnode


def fit_area() -> AreaFit:
    """Least-squares fit of component costs to Table I."""
    # lrscwait: overhead = banks * (ctrl + slot*q)
    a = np.array([[TILE_BANKS, TILE_BANKS * 1],
                  [TILE_BANKS, TILE_BANKS * 8]])
    b = np.array([790 - 691, 865 - 691], float)
    ctrl, slot = np.linalg.solve(a, b)
    # colibri: overhead = banks * (ctrl2 + addr*(A-1)) + cores * qnode
    rows, rhs = [], []
    for name, (A, kge) in PAPER_AREA.items():
        if name.startswith("colibri"):
            rows.append([TILE_BANKS, TILE_BANKS * (A - 1), TILE_CORES])
            rhs.append(kge - TILE_BASE_KGE)
    sol, *_ = np.linalg.lstsq(np.array(rows, float), np.array(rhs), rcond=None)
    ctrl2, addr, qnode = sol
    return AreaFit(float(ctrl), float(slot), float(ctrl2), float(addr),
                   float(qnode))


def tile_area(design: str, param: int, fit: AreaFit = None) -> float:
    """kGE of a MemPool tile with the given synchronization design."""
    fit = fit or fit_area()
    if design == "base":
        return TILE_BASE_KGE
    if design == "lrscwait":
        return TILE_BASE_KGE + TILE_BANKS * (
            fit.lrscwait_ctrl + fit.lrscwait_slot * param)
    if design == "colibri":
        return TILE_BASE_KGE + TILE_BANKS * (
            fit.colibri_ctrl + fit.colibri_addr * (param - 1)) \
            + TILE_CORES * fit.qnode
    raise ValueError(design)


def system_overhead(design: str, n_cores: int, n_banks: int,
                    q: int = 1) -> float:
    """Asymptotic state count (paper Section III-A / IV):
    LRSCwait_ideal is O(n·log2(n)·m); Colibri is O(n + 2m)."""
    if design == "lrscwait_ideal":
        return n_cores * np.log2(max(n_cores, 2)) * n_banks
    if design == "lrscwait_q":
        return q * np.log2(max(n_cores, 2)) * n_banks
    if design == "colibri":
        return n_cores + 2 * n_banks
    raise ValueError(design)


# ---------------------------------------------------------------------------
# Energy model
# ---------------------------------------------------------------------------

#: pJ per NoC hop traversal (router + link segment) under a hierarchical
#: topology.  Table II has no hop-resolved rows (the paper's tile is a
#: flat crossbar), so this is a structural constant from the hierarchical
#: -cluster NoC literature (arXiv:2307.10248-class meshes, ~1 pJ/hop at
#: the reference node), NOT a fitted coefficient: ``fit_energy`` never
#: adjusts it, and flat-topology results (which carry no ``hops`` stat)
#: are billed exactly as before.
E_HOP_PJ = 1.2


@dataclasses.dataclass(frozen=True)
class EnergyFit:
    e_msg: float          # pJ per network message
    e_bank: float         # pJ per bank operation
    e_active: float       # pJ per core-active cycle (issue/stall)
    e_backoff: float      # pJ per backoff-loop cycle (busy wait)
    e_sleep: float        # pJ per clock-gated wait cycle (sleep/barrier)
    residuals: Dict[str, float]
    e_hop: float = E_HOP_PJ   # pJ per NoC hop traversal (structural)


#: stat totals every energy evaluation needs — validated up front so a
#: missing key fails with a clear ValueError instead of a KeyError deep
#: inside the fit (the seed's fit_energy docstring omitted backoff_cyc
#: and the model silently dropped bar_cyc entirely).
REQUIRED_ENERGY_KEYS = ("msgs", "bank_ops", "active_cyc", "sleep_cyc",
                        "backoff_cyc", "bar_cyc", "ops")


def _require_energy_keys(stats: Dict[str, float], who: str) -> None:
    for k in REQUIRED_ENERGY_KEYS:
        if k not in stats:
            raise ValueError(
                f"energy stats for {who!r} missing required key {k!r}; "
                f"required: {', '.join(REQUIRED_ENERGY_KEYS)}")


def fit_energy(stats: Dict[str, Dict[str, float]]) -> EnergyFit:
    """Fit per-event energies so that per-op energy matches Table II.

    ``stats[protocol]`` must provide: msgs, bank_ops, active_cyc,
    sleep_cyc, backoff_cyc, bar_cyc, ops (totals from a
    highest-contention simulation).  BARWAIT cycles are clock-gated
    waits exactly like SLEEP cycles (Glaser et al., arXiv:2004.06662),
    so they are billed at the ``e_sleep`` rate — the seed model charged
    them zero energy, undercounting every ``barrier_phases`` run.
    """
    protos = [p for p in ("amo", "colibri", "lrsc", "amo_lock") if p in stats]
    rows, rhs = [], []
    for pr in protos:
        s = stats[pr]
        _require_energy_keys(s, pr)
        ops = max(s["ops"], 1.0)
        rows.append([s["msgs"] / ops, s["bank_ops"] / ops,
                     (s["active_cyc"] - s["backoff_cyc"]) / ops,
                     s["backoff_cyc"] / ops,
                     (s["sleep_cyc"] + s["bar_cyc"]) / ops])
        rhs.append(PAPER_ENERGY[pr])
    A = np.array(rows, float)
    b = np.array(rhs, float)
    # relative-error weighting (targets span 29..1092 pJ/op), non-negative
    # least squares via projected gradient (tiny problem)
    Aw = A / b[:, None]
    bw = np.ones_like(b)
    x = np.maximum(np.linalg.lstsq(Aw, bw, rcond=None)[0], 0.0)
    lr = 0.5 / max(np.linalg.eigvalsh(Aw.T @ Aw).max(), 1e-12)
    for _ in range(20000):
        g = Aw.T @ (Aw @ x - bw)
        x = np.maximum(x - lr * g, 0.0)
    resid = {pr: float(A[i] @ x - b[i]) for i, pr in enumerate(protos)}
    return EnergyFit(*[float(v) for v in x], residuals=resid)


def energy_per_op(stats: Dict[str, float], fit: EnergyFit) -> float:
    """pJ per completed op for one simulation's stat totals (same
    required keys as :func:`fit_energy`; barrier waits billed at the
    clock-gated ``e_sleep`` rate).  Hierarchical-topology runs carry a
    ``hops`` total (NoC hop traversals, ``core.topologies``) billed at
    ``e_hop`` each; flat runs carry no such key and are billed exactly
    as before."""
    _require_energy_keys(stats, "energy_per_op")
    ops = max(stats["ops"], 1.0)
    total = (fit.e_msg * stats["msgs"] + fit.e_bank * stats["bank_ops"]
             + fit.e_active * (stats["active_cyc"] - stats["backoff_cyc"])
             + fit.e_backoff * stats["backoff_cyc"]
             + fit.e_sleep * (stats["sleep_cyc"] + stats["bar_cyc"]))
    if "hops" in stats:
        total += fit.e_hop * stats["hops"]
    return total / ops


#: Per-event energies fit to Table II at the canonical calibration point
#: (256 cores, 1 hot address, 12 000 cycles; ``amo_lock`` at the paper's
#: fixed 128-cycle backoff) — the values ``benchmarks/bench_energy.py``
#: regenerates, frozen here so every ``run()``/``sweep()`` result can
#: carry ``energy_pj_per_op`` without re-running the calibration sims.
#: ``tests/test_metrics.py`` checks a fresh fit stays within tolerance.
CALIBRATED_ENERGY = EnergyFit(
    e_msg=0.0, e_bank=0.0,
    e_active=0.08835048098662274, e_backoff=0.0,
    e_sleep=0.030535247039837937,
    residuals={"amo": -6.363413044962048, "colibri": 0.0,
               "lrsc": 1.4566872991167656, "amo_lock": 161.3840985167235})


def default_fit() -> EnergyFit:
    """The frozen Table II calibration (:data:`CALIBRATED_ENERGY`)."""
    return CALIBRATED_ENERGY
