"""Post-training quantization (port of ``repro.quant.ptq``; paper
Section 5 'Quantization setup').

  1. ``calibrate``            stream a few batches through the FP model
     with a QuantContext in 'collect' mode; the estimators close into
     static ranges.
  2. ``make_quantized_apply`` close the calibrated context over the apply
     function. PyTorch runs eagerly, so there is nothing to jit.
  3. ``evaluate_perplexity`` token perplexity of the (optionally
     quantized) model; ``ptq_sweep`` repeats calibrate + evaluate over
     calibration seeds (paper protocol: mean and std over 3 seeds).

The pipeline only needs an ``apply(params, batch, ctx)`` callable and a
``loss_fn(params, batch, ctx) -> (sum_nll, n_tokens)``
(``repro_torch.train.losses``). In 'apply' mode every site fake-quantizes
through the hand-written kernel on the card.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
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


def evaluate_perplexity(loss_fn: Callable, params, batches: Iterable,
                        ctx: Optional[QuantContext] = None,
                        max_batches: int = 32) -> float:
    """Average token perplexity of the (optionally quantized) model:
    exp(sum of ``loss_fn``'s NLL / sum of its token counts) over at most
    ``max_batches`` batches."""
    total_nll, total_tok = 0.0, 0
    with torch.no_grad():
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            nll, n = loss_fn(params, batch, ctx)
            total_nll += float(nll)
            total_tok += int(n)
    # exp in f32, as the reference's jnp.exp of a python float
    return float(torch.exp(torch.tensor(total_nll / max(total_tok, 1), dtype=torch.float32)))


def ptq_sweep(apply_fn: ApplyFn, loss_fn: Callable, params,
              calib_batches: Callable[[], Iterable],
              eval_batches: Callable[[], Iterable],
              qconfigs: Dict[str, QConfig],
              seeds: Tuple[int, ...] = (0, 1, 2)) -> Dict[str, Dict[str, float]]:
    """Paper-protocol PTQ: each setting calibrated and evaluated once per
    seed; returns {name: {"ppl_mean", "ppl_std"}}. As in the reference,
    ``calib_batches()`` is called anew for every seed."""
    results: Dict[str, Dict[str, float]] = {}
    for name, qc in qconfigs.items():
        ppls = []
        for _ in seeds:
            ctx = calibrate(apply_fn, params, calib_batches(), qc)
            ppls.append(evaluate_perplexity(loss_fn, params, eval_batches(), ctx))
        results[name] = {"ppl_mean": float(np.mean(ppls)), "ppl_std": float(np.std(ppls))}
    return results
