"""AdamW, int8 gradient compression and LR schedules (port of
``repro.optim``)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.compress import ErrorFeedbackState, compress_grads, ef_init
from repro_torch.optim.schedule import (
    constant,
    linear_warmup_cosine,
    linear_warmup_linear_decay,
)

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm",
    "ErrorFeedbackState", "compress_grads", "ef_init",
    "constant", "linear_warmup_cosine", "linear_warmup_linear_decay",
]
