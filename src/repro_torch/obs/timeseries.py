"""``Timeseries`` — the typed view of the engine's windowed telemetry
(the port's copy of ``repro.obs.timeseries``).

The engine accumulates a ``(n_windows, TELE_K)`` int32 array (result key
``"tele"``) when ``telemetry_windows > 0`` — raw per-window sums (plus
one max column) with the column layout of
:data:`repro_torch.obs.schema.TELE_CHANNELS`.  This module turns that array
into named, normalized series:

* :meth:`Timeseries.counts` — the raw per-window event counts
  (``grants``, ``fails``, ``msgs``, ...);
* :meth:`Timeseries.per_cycle` — the same divided by each window's
  cycle count, so core-count channels (``active``, ``sleeping``, ...)
  become *mean cores in that state* and event channels become rates;
* queue-depth accessors normalizing ``queue_sum`` into mean depth per
  bank (:attr:`queue_depth_mean`) alongside the windowed max
  (:attr:`queue_depth_max`).

Every accessor returns numpy arrays of length :attr:`n_used` (trailing
never-written windows are dropped), aligned with
:attr:`window_start_cycle`.  The schema is identical for all
protocols, so ``Timeseries`` from a Colibri run and an LRSC run plot
against each other directly — the queue drain vs retry storm the
paper's dynamic claims are about.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from repro_torch.obs import schema


@dataclasses.dataclass(frozen=True)
class Timeseries:
    """Windowed in-scan telemetry of one simulation point."""
    #: raw accumulator, ``(n_used, TELE_K)`` int64 (trailing all-zero
    #: windows already dropped)
    tele: np.ndarray
    #: simulated horizon the windows cover
    cycles: int
    #: telemetry_windows the run was configured with
    n_windows: int
    #: banks (addresses) of the run — normalizes ``queue_sum``
    n_addrs: int
    #: cores — normalizes nothing, but viewers want it for axes
    n_cores: int

    # ---- construction ---------------------------------------------------
    @classmethod
    def from_result(cls, result: Any) -> "Timeseries":
        """Build from a ``repro_torch.sync.Result`` (or anything with a
        ``.stats`` mapping and ``.spec``)."""
        stats = result.stats
        if "tele" not in stats:
            raise ValueError(
                "result has no telemetry: run with telemetry_windows > 0 "
                "(e.g. Spec(..., telemetry_windows=64))")
        spec = result.spec
        return cls.from_stats(stats, cycles=spec.costs.cycles,
                              n_addrs=spec.topology.n_addrs,
                              n_cores=spec.topology.n_cores)

    @classmethod
    def from_stats(cls, stats: Dict[str, Any], *, cycles: int,
                   n_addrs: int, n_cores: int) -> "Timeseries":
        """Build from a raw engine result dict."""
        tele = np.asarray(stats["tele"], dtype=np.int64)
        if tele.ndim != 2 or tele.shape[1] != schema.TELE_K:
            raise ValueError(
                f"telemetry array must be (n_windows, {schema.TELE_K}), "
                f"got {tele.shape}")
        n_windows = tele.shape[0]
        used = schema.windows_used(cycles, n_windows)
        return cls(tele=tele[:used], cycles=int(cycles),
                   n_windows=int(n_windows), n_addrs=int(n_addrs),
                   n_cores=int(n_cores))

    # ---- geometry -------------------------------------------------------
    @property
    def n_used(self) -> int:
        """Windows that actually received samples."""
        return self.tele.shape[0]

    @property
    def window_start_cycle(self) -> np.ndarray:
        """(n_used,) first simulated cycle of each window — the x axis."""
        return schema.window_starts(self.cycles, self.n_windows)

    @property
    def window_n_cycles(self) -> np.ndarray:
        """(n_used,) cycles accumulated into each window (tail may be
        shorter)."""
        return schema.window_cycles(self.cycles, self.n_windows)

    def channels(self) -> tuple:
        """The available channel names (``schema.TELE_CHANNELS``)."""
        return schema.TELE_CHANNELS

    # ---- accessors ------------------------------------------------------
    def counts(self, channel: str) -> np.ndarray:
        """Raw per-window accumulated counts for ``channel``.  For
        ``queue_max`` this is the windowed maximum, not a sum."""
        if channel not in schema.TELE_COL:
            raise KeyError(f"unknown telemetry channel {channel!r}; "
                           f"channels: {', '.join(schema.TELE_CHANNELS)}")
        return self.tele[:, schema.TELE_COL[channel]]

    def per_cycle(self, channel: str) -> np.ndarray:
        """``counts(channel)`` divided by each window's cycle count:
        mean cores-in-state for the state channels, events per cycle
        for the outcome/traffic channels."""
        if channel == "queue_max":
            raise ValueError("queue_max is max-accumulated; use "
                             "queue_depth_max (no per-cycle form)")
        return self.counts(channel) / self.window_n_cycles

    # named conveniences (the channels figures actually plot)
    @property
    def active_cores(self) -> np.ndarray:
        """Mean non-sleeping, non-barrier atomic cores per window."""
        return self.per_cycle("active")

    @property
    def sleeping_cores(self) -> np.ndarray:
        """Mean cores asleep in a reservation queue per window — the
        paper's polling-free signature."""
        return self.per_cycle("sleeping")

    @property
    def backoff_cores(self) -> np.ndarray:
        """Mean cores in retry backoff per window — LRSC's retry storm;
        identically zero for the polling-free protocols."""
        return self.per_cycle("backoff")

    @property
    def local_msgs(self) -> np.ndarray:
        """Accepted intra-cluster (local-hop) messages per cycle per
        window.  Under the ``flat`` topology every message is local."""
        return self.per_cycle("loc_msgs")

    @property
    def cross_cluster_msgs(self) -> np.ndarray:
        """Accepted messages per cycle per window that crossed the first
        hierarchy level (``core.topologies``) — the NoC link-occupancy
        split the cluster topologies are about.  Identically zero under
        ``flat``."""
        return self.per_cycle("xcl_msgs")

    @property
    def queue_depth_mean(self) -> np.ndarray:
        """Mean reservation-queue depth per *bank* per window
        (``queue_sum`` / cycles / banks); 0 for queueless protocols."""
        return self.counts("queue_sum") / (
            self.window_n_cycles * max(self.n_addrs, 1))

    @property
    def queue_depth_max(self) -> np.ndarray:
        """Max depth of any single reservation queue in each window."""
        return self.counts("queue_max")

    # ---- serialization --------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict: geometry + one int list per channel."""
        out: Dict[str, Any] = {
            "cycles": self.cycles, "n_windows": self.n_windows,
            "n_used": self.n_used, "n_addrs": self.n_addrs,
            "n_cores": self.n_cores,
            "window_start_cycle": self.window_start_cycle.tolist(),
            "window_n_cycles": self.window_n_cycles.tolist(),
        }
        for name in schema.TELE_CHANNELS:
            out[name] = self.counts(name).tolist()
        return out
