"""Optimizer configuration and LR schedules (port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import (
    constant,
    linear_warmup_cosine,
    linear_warmup_linear_decay,
)

__all__ = ["AdamWConfig", "constant", "linear_warmup_cosine",
           "linear_warmup_linear_decay"]
