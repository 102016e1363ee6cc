"""Event-driven host coordinator — the framework-level Mwait analogue.

The paper's Mwait lets a core sleep until a memory location changes instead
of polling it. At the training-framework level the same anti-pattern is a
coordinator thread polling "is the checkpoint done? did a worker die?" in a
loop. This coordinator is condition-variable based: waiters sleep on an
event name (optionally with an *expected value* — Mwait's race-closing
check) and are woken exactly when it fires.

A copy of the reference's ``repro/distributed/coordinator.py`` (threading
only).  In the port it is used by the serving engine's request queue;
``ElasticController`` is not ported yet; the checkpointer
(``repro_torch.checkpoint``) notifies one when a save is published.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional


class EventCoordinator:
    def __init__(self):
        self._cv = threading.Condition()
        self._values: Dict[str, Any] = {}
        self._seq: Dict[str, int] = defaultdict(int)
        self._subscribers: Dict[str, List[Callable]] = defaultdict(list)

    def notify(self, event: str, **payload):
        """Fire an event (the 'store' that wakes Mwait sleepers)."""
        with self._cv:
            self._values[event] = payload
            self._seq[event] += 1
            subs = list(self._subscribers.get(event, ()))
            self._cv.notify_all()
        for fn in subs:
            fn(**payload)

    def wait(self, event: str, *, expected: Any = None,
             timeout: Optional[float] = None) -> Any:
        """Sleep until ``event`` fires. Like Mwait's expected-value check:
        if the current value already differs from ``expected``, return
        immediately (the change we were waiting for already happened)."""
        with self._cv:
            if event in self._values and self._values[event] != expected:
                return self._values[event]
            start_seq = self._seq[event]
            ok = self._cv.wait_for(lambda: self._seq[event] > start_seq,
                                   timeout=timeout)
            if not ok:
                raise TimeoutError(f"wait({event!r}) timed out")
            return self._values[event]

    def subscribe(self, event: str, fn: Callable):
        with self._cv:
            self._subscribers[event].append(fn)

    def value(self, event: str) -> Any:
        with self._cv:
            return self._values.get(event)
