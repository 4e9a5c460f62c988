"""Losses, train/eval/serve steps, the training loop and FP evaluation
(port of ``repro.train``)."""
from repro_torch.train.losses import clm_loss, frame_loss, loss_for, mlm_loss
from repro_torch.train.step import (
    TrainState,
    TrainTask,
    init_train_state,
    make_decode_step,
    make_eval_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.train.loop import LoopConfig, evaluate, run_training

__all__ = [
    "clm_loss", "frame_loss", "loss_for", "mlm_loss",
    "TrainState", "TrainTask", "init_train_state", "make_decode_step",
    "make_eval_step", "make_prefill_step", "make_train_step",
    "LoopConfig", "evaluate", "run_training",
]
