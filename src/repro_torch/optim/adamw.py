"""AdamW with decoupled weight decay (port of ``repro.optim.adamw``).

Includes the paper's OPT trick (App. B.3): optionally extending weight
decay to LayerNorm scales, which alone dampens outliers — controlled by
``decay_norm_scales``. Weight-decay masking follows the usual convention
(no decay on biases / norm params) unless overridden.

The update is functional, as the reference's: ``adamw_update`` returns
new params and moments (computed under ``torch.no_grad``) and leaves its
inputs as they are. The f32 operations run in the reference's order
(``1 - b ** step`` in f32, ``m / bc1``, ``sqrt(v / bc2) + eps``, ``+ wd *
mask * p``, ``p - lr * delta``), and every division by a computed value
divides by a tensor on the params' device (CUDA would turn a python-float
divisor into a multiplication by its reciprocal).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.nn.module import Params, flatten_params, tree_map, tree_map_with_path

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


class AdamWState(NamedTuple):
    step: torch.Tensor                # int32 scalar
    mu: Params
    nu: Params


def _decay_mask(params: Params, cfg: AdamWConfig) -> Params:
    """Tree of python floats in {0, 1}: 1 where weight decay applies."""
    pats = cfg.no_decay_patterns
    if cfg.decay_norm_scales:
        # keep biases un-decayed but decay norm scales
        pats = (r".*/b$", r".*/bias$", r".*lambda$")
    return tree_map_with_path(lambda path, _: 0.0 if any(
        re.match(p, path) for p in pats) else 1.0, params)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in flatten_params(tree)))


def clip_by_global_norm(grads: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(_scalar(max_norm, norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_init(params: Params) -> AdamWState:
    first = next(flatten_params(params))[1]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


@torch.no_grad()
def adamw_update(
    grads: Params,
    state: AdamWState,
    params: Params,
    cfg: AdamWConfig,
    lr_scale=1.0,
) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, metrics)."""
    metrics: Dict[str, torch.Tensor] = {}
    if cfg.grad_clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
        metrics["grad_norm"] = gnorm
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(_scalar(b1, stepf), stepf)
    bc2 = 1.0 - torch.pow(_scalar(b2, stepf), stepf)
    if isinstance(lr_scale, torch.Tensor):
        lr_scale = lr_scale.to(stepf.device)
    lr = cfg.lr * lr_scale
    eps = _scalar(cfg.eps, stepf)
    mask = dict(flatten_params(_decay_mask(params, cfg)))
    flat_g, flat_m, flat_v = (dict(flatten_params(t)) for t in (grads, state.mu, state.nu))
    new: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
    for path, p in flatten_params(params):
        g32 = flat_g[path].float()
        m_new = b1 * flat_m[path] + (1 - b1) * g32
        v_new = b2 * flat_v[path] + (1 - b2) * torch.square(g32)
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + eps)
        delta = delta + cfg.weight_decay * mask[path] * p.float()
        p_new = p.float() - lr * delta
        new[path] = (p_new.to(p.dtype), m_new, v_new)

    def pick(i):
        return tree_map_with_path(lambda path, _: new[path][i], params)

    new_params = pick(0)
    metrics["update_norm"] = global_norm(
        tree_map(lambda a, b: a.float() - b.float(), new_params, params))
    return new_params, AdamWState(step, pick(1), pick(2)), metrics
