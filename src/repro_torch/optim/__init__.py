"""AdamW of the port (the reference's ``repro/optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, global_norm,
                                     init, schedule, update)

__all__ = ["AdamWConfig", "AdamWState", "global_norm", "init", "schedule",
           "update"]
