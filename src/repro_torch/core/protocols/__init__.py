"""Synchronization protocol plugins for the cycle-level engine (port).

Importing this package registers the protocols the port covers so far:

===============  ========================================================
``amo``          single-instruction atomic add (roofline)
``lrsc``         MemPool LR/SC, one sticky reservation slot (retry storms)
``lrscwait``     q reservation slots, linearized at the LR
``colibri``      LRSCwait with an unbounded distributed queue
``amo_lock``     test&set spin lock by one AMO, fixed backoff
``lrsc_lock``    the same lock by an LR/SC pair (two round trips)
``ticket_lock``  FIFO spin lock: a ticket dispenser and a serving counter
``mwait_lock``   MCS queue lock, waiters sleep via Mwait
===============  ========================================================

The reference's other protocols (``colibri_hier``, ``hw_event``,
``nb_feb``) are not ported yet (ROADMAP A2); asking for one fails at
``SimParams`` construction with ``NotImplementedError``.
"""
from repro_torch.core.protocols import (amo, colibri, locks, lrsc, lrscwait,
                                        mwait)
from repro_torch.core.protocols.base import Ctx, Protocol
from repro_torch.core.protocols.registry import get, names, register

__all__ = ["Ctx", "Protocol", "get", "names", "register",
           "amo", "colibri", "locks", "lrsc", "lrscwait", "mwait"]
