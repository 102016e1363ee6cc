"""The port's checkpointer (the reference's ``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
