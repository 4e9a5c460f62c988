"""Train-task description and the eval step (port of the parts of
``repro.train.step`` that forward evaluation needs).

``TrainTask`` has the reference's fields and defaults. ``make_eval_step``
returns a plain callable (PyTorch runs eagerly, so there is nothing to
jit) that runs one cache-free forward under ``torch.no_grad`` and
returns the batch's summed NLL, its token count and, for a scanned
model, the max |attention-layer output| over layers. The training step
(``make_train_step``) waits for the training slice of the port: it needs
backward kernels for flash attention and fake-quant.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.models.transformer import ModelConfig, model_apply
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import Schedule, constant
from repro_torch.train.losses import loss_for


@dataclasses.dataclass(frozen=True)
class TrainTask:
    cfg: ModelConfig
    loss_kind: str = "clm"            # clm | mlm | frames
    optimizer: AdamWConfig = AdamWConfig()
    schedule: Schedule = dataclasses.field(default_factory=constant)
    moe_lb_weight: float = 0.01
    moe_z_weight: float = 1e-3
    grad_compress: bool = False       # int8 + error feedback
    microbatch: int = 1               # gradient-accumulation splits


def make_eval_step(task: TrainTask) -> Callable:
    def eval_step(params, batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            logits, aux = model_apply(params, task.cfg, batch)
            nll, ntok = loss_for(task.loss_kind)(logits, batch["labels"])
        out = {"nll": nll, "ntok": ntok}
        if "act_stats" in aux:
            out["max_act"] = torch.amax(aux["act_stats"])
        return out

    return eval_step
