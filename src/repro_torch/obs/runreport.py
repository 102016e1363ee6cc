"""``RunReport`` — sweep-runner instrumentation (port of
``repro.obs.runreport``).

The batched sweep (``repro_torch.core.sweep``) launches work in chunks,
one launch of the ``engine_run`` kernel each.  A :class:`RunReport`
records one :class:`ChunkRecord` per launch plus environment facts
(backend, device kind, device count, batch ceiling) and summarizes them
for reports.

Timing model: a chunk's ``compile_s`` is the wall time of building or
loading the CUDA library, when that chunk was the first to need it in
this process (``compiled`` True), else 0; its ``execute_s`` is the
card's time from the chunk's first copy to the host (once the host has
packed the launch) to the end of its one device→host copy, read from
CUDA events (0 on the CPU).  ``persistent_cache_hits``
counts libraries that were found already built on disk.

Usage — ambient::

    from repro_torch import obs
    with obs.collect() as report:
        study.run()
    print(report.summary())

or explicit: ``Study.run(report=report)`` / ``Study.stream(report=...)``
/ ``sweep_iter(..., report=report)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

#: the active ambient report (see :func:`collect` / :func:`current`)
_current: Optional["RunReport"] = None


@dataclasses.dataclass
class ChunkRecord:
    """One launched sweep chunk."""
    label: str            # launch-group summary (protocols/workloads, cores)
    points: int           # configuration points in the chunk
    batch: int            # blocks launched (the points: no padding)
    compile_s: float      # building/loading the CUDA library, when needed
    execute_s: float      # card time, launch to the end of the host copy
    compiled: bool        # this chunk loaded the library into the process

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RunReport:
    """Instrumentation record of one (or more) sweep executions."""
    backend: str = ""               # "cuda" (the kernel) or "cpu" (plain)
    device: str = ""                # device kind (the card's name, "cpu")
    n_devices: int = 0
    max_batch: Optional[int] = None
    chunks: List[ChunkRecord] = dataclasses.field(default_factory=list)
    persistent_cache_hits: int = 0
    started_at: float = dataclasses.field(default_factory=time.time)

    # ---- recording (called by repro_torch.core.sweep) -------------------
    def note_env(self, backend: str, max_batch: int, device=None) -> None:
        """Fill environment facts once per sweep invocation: a sweep runs
        on the one ``device`` it is given."""
        import torch
        self.backend = backend
        self.max_batch = max_batch
        dev = torch.device("cpu" if device is None else device)
        self.device = (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else dev.type)
        self.n_devices = 1

    def record_chunk(self, label: str, points: int, batch: int,
                     compile_s: float, execute_s: float,
                     compiled: bool) -> None:
        self.chunks.append(ChunkRecord(label=label, points=points,
                                       batch=batch, compile_s=compile_s,
                                       execute_s=execute_s,
                                       compiled=compiled))

    # ---- aggregates -----------------------------------------------------
    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def n_points(self) -> int:
        return sum(c.points for c in self.chunks)

    @property
    def n_compiles(self) -> int:
        return sum(c.compiled for c in self.chunks)

    @property
    def compile_s(self) -> float:
        return sum(c.compile_s for c in self.chunks)

    @property
    def execute_s(self) -> float:
        return sum(c.execute_s for c in self.chunks)

    # ---- presentation ---------------------------------------------------
    def summary(self) -> str:
        """One human line: where the sweep wall time went."""
        return (f"{self.n_points} pts / {self.n_chunks} chunks on "
                f"{self.backend or '?'} ({self.n_devices}x"
                f"{self.device or '?'}): compile {self.compile_s:.2f}s "
                f"({self.n_compiles} new), execute {self.execute_s:.2f}s, "
                f"persistent-cache hits {self.persistent_cache_hits}")

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict, with the reference's keys."""
        return {"backend": self.backend, "device": self.device,
                "n_devices": self.n_devices, "max_batch": self.max_batch,
                "n_points": self.n_points, "n_chunks": self.n_chunks,
                "n_compiles": self.n_compiles,
                "compile_s": self.compile_s, "execute_s": self.execute_s,
                "persistent_cache_hits": self.persistent_cache_hits,
                "chunks": [c.to_dict() for c in self.chunks]}


def current() -> Optional[RunReport]:
    """The ambient report sweeps record into, or None."""
    return _current


@contextlib.contextmanager
def collect(report: Optional[RunReport] = None):
    """Collect sweep instrumentation for everything run in this block.

    Yields the active :class:`RunReport`; nests (the previous ambient
    report is restored on exit).
    """
    global _current
    rep = report if report is not None else RunReport()
    prev = _current
    _current = rep
    try:
        yield rep
    finally:
        _current = prev
