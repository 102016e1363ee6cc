"""Synchronization protocol plugins for the cycle-level engine (port).

Importing this package registers the protocols the port covers:

===============  ========================================================
``amo``          single-instruction atomic add (roofline)
``lrsc``         MemPool LR/SC, one sticky reservation slot (retry storms)
``lrscwait``     q reservation slots, linearized at the LR
``colibri``      LRSCwait with an unbounded distributed queue
``amo_lock``     test&set spin lock by one AMO, fixed backoff
``lrsc_lock``    the same lock by an LR/SC pair (two round trips)
``ticket_lock``  FIFO spin lock: a ticket dispenser and a serving counter
``mwait_lock``   MCS queue lock, waiters sleep via Mwait
``colibri_hier`` group-local Colibri queues under a global FIFO of groups
``hw_event``     per-cluster hardware event units, no turn budget
``nb_feb``       full/empty-bit atomics over a waiter FIFO
===============  ========================================================

These are all eleven of the reference's protocols.
"""
from repro_torch.core.protocols import (amo, colibri, colibri_hier, hw_event,
                                        locks, lrsc, lrscwait, mwait, nb_feb)
from repro_torch.core.protocols.base import Ctx, Protocol
from repro_torch.core.protocols.registry import get, names, register

__all__ = ["Ctx", "Protocol", "get", "names", "register",
           "amo", "colibri", "colibri_hier", "hw_event", "locks", "lrsc",
           "lrscwait", "mwait", "nb_feb"]
