"""Losses, the train task and FP evaluation (port of ``repro.train``)."""
from repro_torch.train.loop import evaluate
from repro_torch.train.losses import clm_loss, frame_loss, loss_for, mlm_loss
from repro_torch.train.step import TrainTask, make_eval_step

__all__ = ["clm_loss", "frame_loss", "loss_for", "mlm_loss", "TrainTask",
           "make_eval_step", "evaluate"]
