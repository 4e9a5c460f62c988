"""AdamW's configuration (port of ``repro.optim.adamw.AdamWConfig``, field
for field). The update rule waits for the training slice of the port;
``TrainTask`` carries this config already."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

NO_DECAY_DEFAULT = (r".*(/b|/bias|/scale|lambda)$",)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4                  # peak LR; schedule multiplies this
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip_norm: Optional[float] = 1.0
    decay_norm_scales: bool = False   # paper App. B.3 ("LN gamma wd")
    no_decay_patterns: Tuple[str, ...] = NO_DECAY_DEFAULT
