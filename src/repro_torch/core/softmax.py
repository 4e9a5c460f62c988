"""Softmax variants from the paper, Section 4.1 (port of
``repro.core.softmax``).

    clipped_softmax(x; zeta, gamma) = clip((zeta - gamma) * softmax(x) + gamma, 0, 1)

with gamma <= 0 <= 1 <= zeta (Eq. 4). ``ClippedSoftmaxConfig.resolve_gamma``
implements the length-robust gamma = -alpha / T of Section 5.2.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ClippedSoftmaxConfig:
    """Hyper-parameters of the clipped softmax (paper Eq. 4)."""

    gamma: float = 0.0          # lower stretch, <= 0; 0 disables low clipping
    zeta: float = 1.0           # upper stretch, >= 1; 1 disables high clipping
    # If set, gamma is derived per call as -alpha / T (paper Sec. 5.2) and
    # the static `gamma` above is ignored.
    alpha: Optional[float] = None

    def resolve_gamma(self, seq_len: int) -> float:
        if self.alpha is not None:
            return -float(self.alpha) / float(seq_len)
        return float(self.gamma)

    @property
    def is_vanilla(self) -> bool:
        return self.alpha is None and self.gamma == 0.0 and self.zeta == 1.0


def softmax(logits: torch.Tensor, dim: int = -1,
            where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard softmax with an optional boolean mask (True = attend).
    Fully masked rows give exact zeros."""
    if where is not None:
        logits = torch.where(where, logits, torch.finfo(logits.dtype).min)
    m = torch.amax(logits, dim=dim, keepdim=True)
    unnorm = torch.exp(logits - m)
    if where is not None:
        unnorm = torch.where(where, unnorm, 0.0)
    denom = torch.sum(unnorm, dim=dim, keepdim=True)
    return unnorm / torch.clamp(denom, min=torch.finfo(logits.dtype).tiny)


def stretch_and_clip(probs: torch.Tensor, gamma: float, zeta: float
                     ) -> torch.Tensor:
    """Affine stretch (0,1)->(gamma,zeta), then clip back to [0,1] (Eq. 4)."""
    if gamma == 0.0 and zeta == 1.0:
        return probs
    return torch.clamp((zeta - gamma) * probs + gamma, 0.0, 1.0)


def clipped_softmax(logits: torch.Tensor, gamma: float, zeta: float = 1.0,
                    dim: int = -1, where: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """clip((zeta - gamma) * softmax(x) + gamma, 0, 1) — paper Eq. 4."""
    return stretch_and_clip(softmax(logits, dim=dim, where=where), gamma, zeta)


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap). The divisor
    is a tensor on the logits' device, so CUDA divides as the reference
    does (a python-float divisor becomes a reciprocal multiplication)."""
    if cap is None:
        return logits
    div = torch.full((), cap, dtype=logits.dtype, device=logits.device)
    return cap * torch.tanh(logits / div)
