"""Outlier telemetry (port of ``repro.core.outliers``; paper Section 3 /
Section 5 metrics), computed on the output of an attention layer (or any
activation tensor):

  - max infinity norm  ``max ||x||_inf``  averaged across a validation set,
  - kurtosis of x averaged across layers,
  - 6-sigma outlier counts per hidden dimension / token position (Fig. 1).

Statistics are taken in f32 whatever the activation's dtype, as the
reference's f32 activations give them.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch


def infinity_norm(x: torch.Tensor) -> torch.Tensor:
    """The paper's 'maximum infinity norm': the max abs value of the
    tensor (no batch axis is kept)."""
    return torch.amax(torch.abs(x))


def kurtosis(x: torch.Tensor, axis=None, eps: float = 1e-12) -> torch.Tensor:
    """Pearson kurtosis E[(x-mu)^4] / sigma^4 (not excess)."""
    x = x.float()
    dims = tuple(range(x.ndim)) if axis is None else axis
    mu = torch.mean(x, dim=dims, keepdim=True)
    d = x - mu
    var = torch.mean(d * d, dim=dims, keepdim=True)
    m4 = torch.mean(d ** 4, dim=dims, keepdim=True)
    k = m4 / torch.clamp(var * var, min=eps)
    return k.squeeze() if axis is None else k.squeeze(axis)


def outlier_mask(x: torch.Tensor, n_sigma: float = 6.0) -> torch.Tensor:
    """Boolean mask of values exceeding n_sigma std-devs from the tensor
    mean (the paper follows Bondarenko et al. with n_sigma = 6; the
    population std, as ``jnp.std``)."""
    x = x.float()
    mu = torch.mean(x)
    sigma = torch.std(x, correction=0)
    return torch.abs(x - mu) > n_sigma * sigma


def outlier_counts_by_dim(x: torch.Tensor, n_sigma: float = 6.0) -> torch.Tensor:
    """Outlier counts per hidden dimension (paper Fig. 1, green):
    (..., T, d_model) -> (d_model,) int32."""
    mask = outlier_mask(x, n_sigma)
    return mask.reshape(-1, x.shape[-1]).sum(dim=0).to(torch.int32)


def outlier_counts_by_token(x: torch.Tensor, n_sigma: float = 6.0) -> torch.Tensor:
    """Outlier counts per token position (paper Fig. 1, blue):
    (B, T, d_model) -> (T,) int32."""
    mask = outlier_mask(x, n_sigma)
    return mask.sum(dim=(0, 2)).to(torch.int32)


class OutlierStats:
    """Running aggregate across batches / layers, mirroring the paper's
    reporting: max inf-norm averaged across the validation set, kurtosis
    averaged across layers."""

    def __init__(self) -> None:
        self._inf_norms: List[float] = []      # one per batch (max over layers)
        self._kurtoses: List[float] = []       # one per (batch, layer)

    def update(self, layer_outputs: Sequence[torch.Tensor]) -> None:
        per_layer_inf = [float(infinity_norm(y)) for y in layer_outputs]
        self._inf_norms.append(max(per_layer_inf))
        self._kurtoses.extend(float(kurtosis(y)) for y in layer_outputs)

    def summary(self) -> Dict[str, float]:
        if not self._inf_norms:
            return {"max_inf_norm": 0.0, "avg_kurtosis": 0.0}
        return {
            "max_inf_norm": sum(self._inf_norms) / len(self._inf_norms),
            "avg_kurtosis": sum(self._kurtoses) / max(len(self._kurtoses), 1),
        }


def collect_activation_stats(activations: Mapping[str, torch.Tensor]
                             ) -> Dict[str, Dict[str, float]]:
    """One-shot metrics for a dict of named activations (telemetry hook)."""
    out: Dict[str, Dict[str, float]] = {}
    for name, act in activations.items():
        out[name] = {
            "inf_norm": float(infinity_norm(act)),
            "kurtosis": float(kurtosis(act)),
            "outliers_6sigma": int(outlier_mask(act).sum()),
        }
    return out
