"""Fault schedules (``repro_torch.faults``).

:class:`FaultPlan` is the declarative fault schedule ``Spec(faults=...)``
accepts.  The port carries the plan so that ``Spec``/``SimParams`` keep
the reference's shape and JSON; its engine runs only the default
no-fault plan and refuses an enabled one.
"""
from repro_torch.faults.plan import DROP_DENOM, FaultPlan

__all__ = ["DROP_DENOM", "FaultPlan"]
