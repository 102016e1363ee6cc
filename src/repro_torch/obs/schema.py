"""Shared telemetry/trace schema of the port's observability views.

The port's copy of the reference's ``repro.obs.schema``: the windowed
telemetry channel layout the engine (``core.sim``) accumulates when
``telemetry_windows > 0`` and :class:`repro_torch.obs.Timeseries` reads
back, the core-state names of the event-trace layer, and the window
geometry helpers shared by the accumulator and the viewers.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.protocols.base import (BACKOFF, BARWAIT, MOD, REQ,
                                             RESP, SLEEP, WORK)

#: telemetry channel names, in column order.  All but the last are
#: per-window **sums** (core-count channels sum one count per cycle, so
#: dividing by the window's cycle count gives a mean); the final
#: ``queue_max`` column is max-accumulated.
#:
#: ``active``/``sleeping``/``backoff``/``barwait`` — per-cycle core
#: counts by state (``active`` = non-sleeping, non-barrier, non-worker
#: cores, exactly the engine's ``active_cyc`` accounting).
#: ``grants``/``retires``/``fails``/``enqueues`` — bank-access outcome
#: counts, one per served winner (the ``OUT_GRANT``/``OUT_DONE``/
#: ``OUT_FAIL``/``OUT_SLEEP`` codes).  ``wakes`` — cores moved out of
#: SLEEP by a protocol wake-up this window.  ``msgs``/``net_stall`` —
#: NoC messages and rejected network requests.  ``loc_msgs``/
#: ``xcl_msgs`` — accepted requests whose (core, bank) path stays inside
#: the leaf cluster vs those crossing a cluster boundary (under ``flat``
#: every accepted request is local and ``xcl_msgs`` is 0).
#: ``queue_sum`` — per-cycle sum of all reservation-queue depths;
#: ``queue_max`` — max depth seen in the window.
TELE_CHANNELS = ("active", "sleeping", "backoff", "barwait",
                 "grants", "retires", "fails", "enqueues", "wakes",
                 "msgs", "net_stall", "loc_msgs", "xcl_msgs",
                 "queue_sum", "queue_max")

#: number of telemetry columns; the engine's accumulator is
#: ``(n_windows, TELE_K)``
TELE_K = len(TELE_CHANNELS)

#: columns 0..TELE_NSUM-1 are add-accumulated; column TELE_NSUM
#: (``queue_max``) is max-accumulated
TELE_NSUM = TELE_K - 1

#: column index by channel name
TELE_COL: Dict[str, int] = {name: i for i, name in enumerate(TELE_CHANNELS)}

#: engine core-state code -> human/Perfetto label
STATE_NAMES: Dict[int, str] = {
    WORK: "WORK", REQ: "REQ", SLEEP: "SLEEP", MOD: "MOD",
    BACKOFF: "BACKOFF", RESP: "RESP", BARWAIT: "BARWAIT",
}

#: the waiting states (viewers style spans by them)
WAIT_STATES = frozenset((SLEEP, BACKOFF, BARWAIT))


def window_len(cycles: int, n_windows: int) -> int:
    """Cycles per telemetry window: ``ceil(cycles / n_windows)``.  The
    engine maps cycle ``c`` to window ``c // window_len``; the last used
    window may cover fewer cycles, and trailing windows stay zero."""
    if n_windows < 1:
        raise ValueError(f"n_windows must be >= 1 (got {n_windows})")
    return -(-cycles // n_windows)


def windows_used(cycles: int, n_windows: int) -> int:
    """How many leading windows actually receive samples."""
    return -(-cycles // window_len(cycles, n_windows))


def window_starts(cycles: int, n_windows: int) -> np.ndarray:
    """(windows_used,) first cycle of each used window."""
    cw = window_len(cycles, n_windows)
    return np.arange(windows_used(cycles, n_windows), dtype=np.int64) * cw


def window_cycles(cycles: int, n_windows: int) -> np.ndarray:
    """(windows_used,) number of cycles accumulated into each used
    window (the divisor for per-cycle means)."""
    cw = window_len(cycles, n_windows)
    starts = window_starts(cycles, n_windows)
    return np.minimum(starts + cw, cycles) - starts
