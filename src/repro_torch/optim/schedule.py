"""LR schedules as pure functions step -> multiplier (port of
``repro.optim.schedule``; the peak LR lives in ``AdamWConfig``): linear
warmup + linear decay (BERT/OPT pre-training) and cosine with warmup
(ViT). Each returns an f32 scalar tensor; a tensor step keeps its
device."""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).float()


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    # a divisor tensor on a's device: a true f32 division on CUDA too
    return a / torch.full((), float(b), dtype=torch.float32, device=a.device)


def linear_warmup_linear_decay(warmup: int, total: int) -> Schedule:
    def fn(step):
        step = _step(step)
        warm = _div(step, max(warmup, 1))
        decay = _div(total - step, max(total - warmup, 1))
        return torch.clamp(torch.minimum(warm, decay), 0.0, 1.0)
    return fn


def linear_warmup_cosine(warmup: int, total: int, min_frac: float = 0.01) -> Schedule:
    def fn(step):
        step = _step(step)
        warm = _div(step, max(warmup, 1))
        prog = torch.clamp(_div(step - warmup, max(total - warmup, 1)), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant() -> Schedule:
    return lambda step: torch.ones((), dtype=torch.float32)
