"""Host-side coordination of the port (the reference's
``repro.distributed`` without its mesh ``Policy``, which the port does not
need: it runs on one card)."""
from repro_torch.distributed.coordinator import EventCoordinator

__all__ = ["EventCoordinator"]
