"""Synchronization protocol plugins for the cycle-level engine (port).

Importing this package registers the protocols the port covers so far:

=============  ==========================================================
``amo``        single-instruction atomic add (roofline)
``lrsc``       MemPool LR/SC, one sticky reservation slot (retry storms)
``lrscwait``   q reservation slots, linearized at the LR
``colibri``    LRSCwait with an unbounded distributed queue
=============  ==========================================================

The reference's other protocols (the locks, ``mwait_lock``,
``colibri_hier``, ``hw_event``, ``nb_feb``) are not ported yet; asking
for one fails at ``SimParams`` construction with the list above.
"""
from repro_torch.core.protocols import amo, colibri, lrsc, lrscwait
from repro_torch.core.protocols.base import Ctx, Protocol
from repro_torch.core.protocols.registry import get, names, register

__all__ = ["Ctx", "Protocol", "get", "names", "register",
           "amo", "colibri", "lrsc", "lrscwait"]
