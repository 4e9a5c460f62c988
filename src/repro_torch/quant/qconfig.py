"""Model-level quantization configuration and the ``QuantContext``
threaded through model apply (port of ``repro.quant.qconfig``).

The paper's PTQ protocol (Section 5, App. C.4): quantize all weights and
all activations, symmetric uniform weights and asymmetric uniform
activations, static activation ranges from a few calibration batches,
the final LM-head linear skipped.

Every layer calls ``ctx.act(name, x)`` on activations and
``ctx.weight(name, w)`` on parameters right before use. Modes:

  off      identity
  collect  record tensors for range estimation
  apply    fake-quantize with the finalized (s, z)
  int8     hardware W8A8: ``act``/``weight`` are identity; linears that
           carry attached int8 weights (``quant.int8_weights``) take their
           static input (s, z) from ``act_qparams`` and run the integer
           kernel. Reached from 'apply' through ``use_int8_runtime``.

Site names are the reference's, and so is a property of them: a block's
name is its index inside the layer pattern (``layer_attn0`` in every
group), so all layers of one kind share one site and one estimator,
which folds the layers in forward order.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch

from repro_torch.quant.quantizer import QuantSpec, fake_quant, scale_zero_point
from repro_torch.quant.ranges import RangeEstimator, make_estimator

_MODES = ("off", "collect", "apply", "int8")


@dataclasses.dataclass(frozen=True)
class QConfig:
    """What to quantize and how (one per experiment row, e.g. 'W8A8')."""

    weight_bits: int = 8
    act_bits: int = 8
    weight_estimator: str = "minmax"      # "minmax" | "mse"
    act_estimator: str = "running_minmax" # + "percentile", "mse"
    act_estimator_kwargs: tuple = ()      # e.g. (("percentile", 99.999),)
    skip_patterns: Tuple[str, ...] = (r".*lm_head.*",)  # final linear skipped
    per_channel_weights: bool = False      # paper uses per-tensor

    @property
    def name(self) -> str:
        return f"W{self.weight_bits}A{self.act_bits}"

    def weight_spec(self, ndim: int = 2) -> QuantSpec:
        axis = (ndim - 1) if self.per_channel_weights else None
        return QuantSpec(bits=self.weight_bits, symmetric=True, per_channel_axis=axis)

    def act_spec(self) -> QuantSpec:
        return QuantSpec(bits=self.act_bits, symmetric=False)

    def skipped(self, name: str) -> bool:
        return any(re.match(p, name) for p in self.skip_patterns)


class QuantContext:
    """Threaded through model apply; see the module docstring."""

    def __init__(self, qconfig: Optional[QConfig], mode: str = "off") -> None:
        if mode not in _MODES:
            raise ValueError(f"unknown QuantContext mode {mode!r}")
        self.qconfig = qconfig
        self.mode = mode if qconfig is not None else "off"
        self._estimators: Dict[str, RangeEstimator] = {}
        self._ranges: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        # site -> (scale, zero) f32 tensors, computed once from the ranges
        # (``_set_ranges``); ``_placed`` holds them on the forwards' device
        # with that device, moved there in one copy by the first forward
        self._qparams: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._placed: Optional[Tuple[torch.device,
                                     Dict[str, Tuple[torch.Tensor, torch.Tensor]]]] = None
        # site -> (scale, zero) python floats, made by use_int8_runtime so
        # that the serving tick reads no device value
        self._act_qp: Dict[str, Tuple[float, float]] = {}

    # -- calibration ------------------------------------------------------
    def _estimator_for(self, name: str, spec: QuantSpec, kind: str) -> RangeEstimator:
        if name not in self._estimators:
            kw = dict(self.qconfig.act_estimator_kwargs) if not spec.symmetric else {}
            self._estimators[name] = make_estimator(kind, spec, **kw)
        return self._estimators[name]

    def finalize(self) -> None:
        """Close all estimators into static ranges; switch to 'apply'."""
        self._set_ranges({name: est.finalize() for name, est in self._estimators.items()})

    @property
    def ranges(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return dict(self._ranges)

    def load_ranges(self, ranges: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
        self._set_ranges(dict(ranges))

    def _set_ranges(self, ranges: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Static ranges in; each site's (s, z) computed once, here, by
        ``scale_zero_point`` (so the values are those it gives), and the
        context switched to 'apply'."""
        self._ranges = ranges
        self._qparams = {}
        for name, (lo, hi) in (ranges.items() if self.qconfig is not None else ()):
            spec = self.qconfig.weight_spec() if name.endswith("#w") \
                else self.qconfig.act_spec()
            self._qparams[name] = scale_zero_point(lo, hi, spec)
        self._placed = None
        self.mode = "apply"

    def _site_qparams(self, name: str, device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A site's (s, z) on ``device``. All sites move together, in one
        copy, when the forwards' device is new: a forward then makes no
        host-to-device copy and no sync per site."""
        if self._placed is None or self._placed[0] != device:
            leaves = [t for pair in self._qparams.values() for t in pair]
            flat = torch.cat([t.reshape(-1).float() for t in leaves]).to(device)
            chunks = iter(flat.split([t.numel() for t in leaves]))
            self._placed = (device, {n: tuple(next(chunks).reshape(t.shape) for t in pair)
                                     for n, pair in self._qparams.items()})
        return self._placed[1][name]

    def use_int8_runtime(self) -> None:
        """Switch a calibrated context to the hardware int8 path: the
        fake-quant sites become identity and every activation site's
        (s, z) is materialized here as python floats."""
        if not (self._ranges or self.mode == "apply"):
            raise RuntimeError("use_int8_runtime needs finalized calibration ranges")
        self._act_qp = {name: (float(s), float(z)) for name, (s, z) in self._qparams.items()
                        if not name.endswith("#w")}     # weight ranges: not activation sites
        self.mode = "int8"

    def act_qparams(self, name: str) -> Optional[Tuple[float, float]]:
        """Static (scale, zero_point) of an activation site as python
        floats; None if the site was not calibrated or is skipped (the
        caller then ranges the activation dynamically)."""
        if self.qconfig is None or self.qconfig.skipped(name):
            return None
        return self._act_qp.get(name)

    # -- the two quantization sites --------------------------------------
    def act(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if (self.mode in ("off", "int8") or self.qconfig is None
                or self.qconfig.skipped(name)):
            return x
        spec = self.qconfig.act_spec()
        if self.mode == "collect":
            self._estimator_for(name, spec, self.qconfig.act_estimator).update(x)
            return x
        if name not in self._ranges:   # site unseen during calibration
            return x
        s, z = self._site_qparams(name, x.device)
        return fake_quant(x, s, z, spec)

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        if (self.mode in ("off", "int8") or self.qconfig is None
                or self.qconfig.skipped(name)):
            return w
        spec = self.qconfig.weight_spec(w.ndim)
        wname = name + "#w"
        if self.mode == "collect":
            self._estimator_for(wname, spec, self.qconfig.weight_estimator).update(w)
            return w
        if wname not in self._ranges:
            lo, hi = torch.aminmax(w)       # weights are static: min-max
            s, z = scale_zero_point(lo, hi, spec)
        else:
            s, z = self._site_qparams(wname, w.device)
        return fake_quant(w, s, z, spec)


NO_QUANT = QuantContext(None, "off")
