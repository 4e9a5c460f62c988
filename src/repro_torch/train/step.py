"""Train / eval / serve step builders (port of ``repro.train.step``).

PyTorch runs eagerly, so each builder returns a plain callable:

  * ``make_train_step(task)`` -> ``train_step(state, batch) -> (state,
    metrics)``: the loss and its gradient by autograd (on the card the
    attention's gradient is the hand-written flash backward kernel, see
    ``kernels/flash_attention.py``), optional micro-batching (the batch
    split along its first axis, f32 gradients summed and divided by the
    number of splits, the loss averaged, the other metrics of the last
    split), optional int8 gradient compression with error feedback, the
    LR schedule and AdamW. The update is functional: the returned state
    holds new tensors and the input state is left as it was.
  * ``make_eval_step`` -> the batch's summed NLL, its token count and,
    for a scanned model, the max |attention-layer output| over layers.
  * ``make_prefill_step`` / ``make_decode_step``: last-position logits of
    a cache-free forward; one greedy token against a cache at ``pos``.

``TrainState`` keeps the reference's field order, so a checkpoint's
paths (``0/...`` params, ``1/0`` optimizer step, ``1/1/...`` and
``1/2/...`` moments, ``2/0/...`` error feedback, ``3`` step) are the
reference's and checkpoints cross between the packages. A MoE config's
loss adds ``moe_lb_weight`` times the load-balance loss and
``moe_z_weight`` times the router z-loss, each summed over the layers and
divided by ``n_layers``; the metrics carry them as ``moe_lb`` and
``moe_z``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.transformer import ModelConfig, model_apply
from repro_torch.nn.module import flatten_params, tree_map_with_path
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.optim.compress import ErrorFeedbackState, compress_grads, ef_init
from repro_torch.optim.schedule import Schedule, constant
from repro_torch.train.losses import loss_for


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Optional[ErrorFeedbackState]
    step: torch.Tensor                # int32 scalar on the params' device


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


def init_train_state(seed, task: TrainTask, device="cuda") -> TrainState:
    """Random weights from ``seed`` (``model_init``) on ``device``, zero
    moments, step 0."""
    from repro_torch.models.transformer import model_init

    params = model_init(seed, task.cfg, device=device)
    first = next(flatten_params(params))[1]
    return TrainState(
        params=params,
        opt=adamw_init(params),
        ef=ef_init(params) if task.grad_compress else None,
        step=torch.zeros((), dtype=torch.int32, device=first.device),
    )


def _loss_and_metrics(params, task: TrainTask, batch
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = model_apply(params, task.cfg, batch)
    nll, ntok = loss_for(task.loss_kind)(logits, batch["labels"])
    loss = nll / torch.clamp(ntok, min=1.0)
    metrics = {"loss": loss.detach(), "ntok": ntok}
    moe = aux.get("moe_aux")
    if moe is not None and task.cfg.moe is not None:
        n_moe = max(task.cfg.n_layers, 1)
        lb = moe["load_balance"] / n_moe
        rz = moe["router_z"] / n_moe
        loss = loss + task.moe_lb_weight * lb + task.moe_z_weight * rz
        metrics.update(moe_lb=lb.detach(), moe_z=rz.detach())
    if "act_stats" in aux:
        metrics["max_act"] = torch.amax(aux["act_stats"]).detach()
    return loss, metrics


def _grads(params, task: TrainTask, batch):
    """(loss, metrics, f32-or-param-dtype grads tree) of one batch."""
    paths = [p for p, _ in flatten_params(params)]
    live = tree_map_with_path(lambda _, p: p.detach().requires_grad_(True), params)
    leaves = [p for _, p in flatten_params(live)]
    loss, metrics = _loss_and_metrics(live, task, batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    flat = {path: torch.zeros_like(p) if g is None else g
            for path, p, g in zip(paths, leaves, gs)}
    return loss.detach(), metrics, tree_map_with_path(lambda path, _: flat[path], params)


def _step_grads(params, task: TrainTask, batch):
    """(metrics, grads) of one train step before compression: one batch,
    or ``task.microbatch`` splits along the first axis with their f32
    gradients summed and divided by the number of splits, the loss
    averaged and the other metrics of the last split."""
    if task.microbatch <= 1:
        _, metrics, grads = _grads(params, task, batch)
        return metrics, grads
    mb = task.microbatch
    micro = [{k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
              for k, v in batch.items()} for i in range(mb)]
    grads = tree_map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    first = next(flatten_params(params))[1]
    loss = torch.zeros((), device=first.device)
    for mbatch in micro:
        mloss, metrics, g = _grads(params, task, mbatch)
        flat = dict(flatten_params(g))
        grads = tree_map_with_path(lambda path, acc: acc + flat[path], grads)
        loss = loss + mloss
    div = torch.full((), float(mb), device=first.device)
    metrics["loss"] = loss / div
    return metrics, tree_map_with_path(lambda _, g: g / div, grads)


def make_train_step(task: TrainTask) -> Callable:
    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        metrics, grads = _step_grads(state.params, task, batch)
        ef = state.ef
        if task.grad_compress and ef is not None:
            grads, ef = compress_grads(grads, ef)

        lr_scale = torch.as_tensor(task.schedule(state.step)).to(state.step.device)
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, task.optimizer, lr_scale)
        metrics.update(opt_metrics)
        metrics["lr_scale"] = lr_scale
        return TrainState(new_params, new_opt, ef, state.step + 1), metrics

    return train_step


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


# --------------------------------------------------------------------------
# Serving steps
# --------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = model_apply(params, cfg, batch)
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """One new token against an existing KV cache at position ``pos``."""

    def decode_step(params, cache, tokens, pos):
        with torch.no_grad():
            logits, aux = model_apply(params, cfg, {"tokens": tokens}, cache=cache, pos=pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], aux["cache"]

    return decode_step
