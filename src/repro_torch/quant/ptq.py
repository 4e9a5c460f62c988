"""Post-training quantization (port of ``repro.quant.ptq``; paper
Section 5 'Quantization setup').

  1. ``calibrate``            stream a few batches through the FP model
     with a QuantContext in 'collect' mode; the estimators close into
     static ranges.
  2. ``make_quantized_apply`` close the calibrated context over the apply
     function. PyTorch runs eagerly, so there is nothing to jit.

The pipeline only needs an ``apply(params, batch, ctx)`` callable.
``evaluate_perplexity`` and ``ptq_sweep`` wait for the loss functions of
``train/``.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from repro_torch.quant.qconfig import QConfig, QuantContext

ApplyFn = Callable[..., torch.Tensor]


def calibrate(apply_fn: ApplyFn, params, batches: Iterable, qconfig: QConfig,
              num_batches: int = 16) -> QuantContext:
    """Run ``num_batches`` through the FP network recording ranges (the
    paper uses 16 batches with running min-max, momentum 0.9)."""
    ctx = QuantContext(qconfig, mode="collect")
    with torch.no_grad():
        for i, batch in enumerate(batches):
            if i >= num_batches:
                break
            apply_fn(params, batch, ctx)
    ctx.finalize()
    return ctx


def make_quantized_apply(apply_fn: ApplyFn, ctx: QuantContext):
    """Close the calibrated context over the apply function."""
    def q_apply(params, batch):
        return apply_fn(params, batch, ctx)
    return q_apply
