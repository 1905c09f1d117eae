"""Checkpoints of the port, as ``src/repro/checkpoint/``."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
