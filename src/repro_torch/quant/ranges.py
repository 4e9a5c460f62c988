"""Quantization range estimators (port of ``repro.quant.ranges``; paper
Appendix C.4).

  - ``MinMaxEstimator``        : running exact min/max
  - ``RunningMinMaxEstimator`` : EMA of batch min/max, momentum 0.9
  - ``PercentileEstimator``    : 99.99% / 99.999% percentiles
  - ``MSEEstimator``           : grid-search the clipping range minimizing
                                 fake-quant MSE

They keep python floats and draw their subsamples from numpy
``default_rng`` with the reference's seeds, so the same batches give the
same ``(lo, hi)``. ``update`` reads a batch's min/max back to the host:
estimators run during calibration, never in the serving tick.
``finalize`` returns f32 scalar tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.quant.quantizer import QuantSpec, quantization_error, scale_zero_point


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


class RangeEstimator:
    """Base: stateful accumulator over calibration batches."""

    def update(self, x: torch.Tensor) -> None:
        raise NotImplementedError

    def finalize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


def _batch_range(x: torch.Tensor) -> Tuple[float, float]:
    lo, hi = torch.aminmax(x.detach())
    return float(lo), float(hi)


def _require(seen: bool) -> None:
    if not seen:
        raise RuntimeError("estimator saw no data")


class MinMaxEstimator(RangeEstimator):
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def update(self, x: torch.Tensor) -> None:
        lo, hi = _batch_range(x)
        self._min = lo if self._min is None else min(self._min, lo)
        self._max = hi if self._max is None else max(self._max, hi)

    def finalize(self):
        _require(self._min is not None)
        return _f32(self._min), _f32(self._max)


class RunningMinMaxEstimator(RangeEstimator):
    """Exponential moving average of per-batch min/max (Krishnamoorthi)."""

    def __init__(self, momentum: float = 0.9) -> None:
        self.momentum = momentum
        self.reset()

    def reset(self) -> None:
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def update(self, x: torch.Tensor) -> None:
        lo, hi = _batch_range(x)
        if self._min is None:
            self._min, self._max = lo, hi
        else:
            m = self.momentum
            self._min = m * self._min + (1 - m) * lo
            self._max = m * self._max + (1 - m) * hi

    def finalize(self):
        _require(self._min is not None)
        return _f32(self._min), _f32(self._max)


class PercentileEstimator(RangeEstimator):
    """min/max replaced by (1-p)/p percentiles of the pooled sample, with a
    bounded reservoir per batch."""

    def __init__(self, percentile: float = 99.999, reservoir: int = 1 << 20) -> None:
        if not 50.0 < percentile < 100.0:
            raise ValueError(f"percentile {percentile} outside (50, 100)")
        self.percentile = percentile
        self.reservoir = reservoir
        self.reset()

    def reset(self) -> None:
        self._samples: list = []
        self._rng = np.random.default_rng(0)

    def update(self, x: torch.Tensor) -> None:
        flat = x.detach().float().cpu().numpy().reshape(-1)
        if flat.size > self.reservoir:
            flat = self._rng.choice(flat, size=self.reservoir, replace=False)
        self._samples.append(flat)

    def finalize(self):
        _require(bool(self._samples))
        pooled = np.concatenate(self._samples)
        lo = np.percentile(pooled, 100.0 - self.percentile)
        hi = np.percentile(pooled, self.percentile)
        return _f32(lo), _f32(hi)


class MSEEstimator(RangeEstimator):
    """Clipping-range grid search minimizing fake-quant MSE over an
    independent grid of lo/hi factors in (0, 1] of the observed range."""

    def __init__(self, spec: QuantSpec, n_candidates: int = 40) -> None:
        self.spec = spec
        self.n_candidates = n_candidates
        self.reset()

    def reset(self) -> None:
        self._batches: list = []
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def update(self, x: torch.Tensor) -> None:
        lo, hi = _batch_range(x)
        self._min = lo if self._min is None else min(self._min, lo)
        self._max = hi if self._max is None else max(self._max, hi)
        flat = x.detach().float().reshape(-1)
        if flat.numel() > (1 << 18):
            idx = np.random.default_rng(len(self._batches)).choice(
                flat.numel(), size=1 << 18, replace=False)
            flat = flat[torch.as_tensor(idx, device=flat.device)]
        self._batches.append(flat)

    def finalize(self):
        _require(bool(self._batches))
        pooled = torch.cat(self._batches)
        n = max(int(self.n_candidates ** 0.5), 6)
        factors = np.linspace(1.0 / n, 1.0, n)
        best = (None, np.inf)
        for f_lo in factors:
            for f_hi in factors:
                lo = _f32(self._min * f_lo)
                hi = _f32(self._max * f_hi)
                s, z = scale_zero_point(lo, hi, self.spec)
                err = float(quantization_error(pooled, s.to(pooled.device),
                                               z.to(pooled.device), self.spec))
                if err < best[1]:
                    best = ((lo, hi), err)
        return best[0]


def make_estimator(kind: str, spec: QuantSpec, **kw) -> RangeEstimator:
    if kind == "minmax":
        return MinMaxEstimator()
    if kind == "running_minmax":
        return RunningMinMaxEstimator(**kw)
    if kind == "percentile":
        return PercentileEstimator(**kw)
    if kind == "mse":
        return MSEEstimator(spec, **kw)
    raise ValueError(f"unknown range estimator {kind!r}")
