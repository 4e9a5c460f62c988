"""Training loop with outlier telemetry, checkpoint/restart and straggler
timing telemetry, and FP evaluation (port of ``repro.train.loop``; the
paper's pre-training protocol and Section 5's evaluation)."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core.outliers import OutlierStats
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.transformer import model_apply
from repro_torch.nn.module import flatten_params
from repro_torch.train.step import (
    TrainTask,
    init_train_state,
    make_eval_step,
    make_train_step,
)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 200
    eval_every: int = 100
    eval_batches: int = 8
    ckpt_every: int = 0              # 0 = disabled
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 20
    seed: int = 0
    # straggler telemetry: steps slower than `straggler_factor` x median are
    # counted and reported
    straggler_factor: float = 2.0


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def run_training(
    task: TrainTask,
    data: SyntheticLM,
    loop: LoopConfig,
    batch_kind: str = "clm",
    log: Callable[[str], None] = print,
    device="cuda",
) -> Dict[str, object]:
    """Train from ``init_train_state(loop.seed)`` on ``device`` or, when
    ``loop.ckpt_dir`` holds a checkpoint, from its latest step (a
    checkpoint of either package). Batch ``i`` of ``data`` feeds step
    ``i``. Returns, as the reference, the final state, the history of
    losses and outlier metrics at the eval cadence (``step / loss /
    eval_ppl / max_inf_norm / kurtosis``), the straggler count and the
    median step time; and, beside them, every step's loss (``losses``)
    and wall time (``step_s``). A step is timed on the host clock up to a
    ``torch.cuda.synchronize()`` on the card (the reference's
    ``block_until_ready``)."""
    dev = resolve_device(device)
    state = init_train_state(loop.seed, task, device=dev)
    start_step = 0
    if loop.ckpt_dir and latest_step(loop.ckpt_dir) is not None:
        state, start_step = restore_checkpoint(loop.ckpt_dir, state)
        log(f"[resume] restored step {start_step} from {loop.ckpt_dir}")

    train_step = make_train_step(task)
    eval_step = make_eval_step(task)

    history: Dict[str, List[float]] = {
        "step": [], "loss": [], "eval_ppl": [], "max_inf_norm": [], "kurtosis": [],
    }
    durations: List[float] = []
    losses: List[float] = []
    stragglers = 0

    for step in range(start_step, loop.total_steps):
        batch = _to_device(data.batch(step, batch_kind), dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        durations.append(dt)
        losses.append(float(metrics["loss"]))
        if len(durations) > 10:
            med = float(np.median(durations[-100:]))
            if dt > loop.straggler_factor * med:
                stragglers += 1

        if loop.log_every and (step + 1) % loop.log_every == 0:
            log(f"step {step+1:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics.get('grad_norm', 0)):.2f} "
                f"max_act {float(metrics.get('max_act', 0)):.1f} {dt*1e3:.0f}ms")

        if loop.eval_every and (step + 1) % loop.eval_every == 0:
            ppl, ostats = evaluate(task, state.params, data, loop.eval_batches,
                                   batch_kind, eval_step)
            history["step"].append(step + 1)
            history["loss"].append(float(metrics["loss"]))
            history["eval_ppl"].append(ppl)
            history["max_inf_norm"].append(ostats["max_inf_norm"])
            history["kurtosis"].append(ostats["avg_kurtosis"])
            log(f"  eval ppl {ppl:.3f} inf_norm {ostats['max_inf_norm']:.1f} "
                f"kurtosis {ostats['avg_kurtosis']:.0f}")

        if loop.ckpt_every and loop.ckpt_dir and (step + 1) % loop.ckpt_every == 0:
            save_checkpoint(loop.ckpt_dir, step + 1, state, loop.keep_ckpts)

    if loop.ckpt_dir and loop.ckpt_every:
        save_checkpoint(loop.ckpt_dir, loop.total_steps, state, loop.keep_ckpts)

    return {
        "state": state,
        "history": history,
        "stragglers": stragglers,
        "median_step_s": float(np.median(durations)) if durations else 0.0,
        "losses": losses,
        "step_s": durations,
    }


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
