from repro_torch.checkpoint.checkpointer import AsyncSaver, load, save
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["AsyncSaver", "load", "save", "CheckpointManager"]
