"""Checkpointing in the reference's on-disk format (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
