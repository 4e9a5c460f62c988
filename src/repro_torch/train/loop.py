"""FP evaluation with outlier telemetry (port of ``repro.train.loop
.evaluate``; paper Section 5's protocol). The training loop
(``run_training``) waits for the training slice of the port."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.outliers import OutlierStats
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.transformer import model_apply
from repro_torch.nn.module import flatten_params
from repro_torch.train.step import TrainTask, make_eval_step


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def evaluate(task: TrainTask, params, data: SyntheticLM, n_batches: int,
             batch_kind: str, eval_step: Optional[Callable] = None,
             eval_offset: int = 10_000_000):
    """Perplexity + paper outlier metrics on held-out (offset) batches.

    As the reference: batch ``eval_offset + i`` of ``data`` goes through
    ``eval_step`` (summed NLL and token count) and through a second
    forward with ``collect_acts=True`` whose per-layer attention-layer
    outputs feed ``OutlierStats``. Batches go to the params' device.
    Returns (ppl, {"max_inf_norm", "avg_kurtosis"})."""
    if eval_step is None:
        eval_step = make_eval_step(task)
    device = next(flatten_params(params))[1].device
    nll = tok = 0.0
    ostats = OutlierStats()
    for i in range(n_batches):
        batch = _to_device(data.batch(eval_offset + i, batch_kind), device)
        out = eval_step(params, batch)
        nll += float(out["nll"])
        tok += float(out["ntok"])
        with torch.no_grad():
            _, aux = model_apply(params, task.cfg, batch, collect_acts=True)
        acts = aux.get("attn_outputs", [])
        if acts:
            ostats.update(acts)
        del aux, acts
    ppl = float(np.exp(nll / max(tok, 1.0)))
    return ppl, ostats.summary()

