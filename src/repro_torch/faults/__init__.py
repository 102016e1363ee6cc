"""Fault schedules (``repro_torch.faults``).

:class:`FaultPlan` is the declarative fault schedule ``Spec(faults=...)``
accepts: deterministic core kills and stalls, request and wakeup drops
and bank stalls, with the reservation watchdog and the progress
detector.  The engine runs an enabled plan in the plain loop (CPU) and
in the run kernel's fault instance (GPU), bit for bit as the reference;
the empty plan adds no key and no work.
"""
from repro_torch.faults.plan import DROP_DENOM, FaultPlan

__all__ = ["DROP_DENOM", "FaultPlan"]
