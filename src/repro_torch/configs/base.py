"""The paper's technique as a config transform (port of
``repro.configs.base.apply_method``).

``method`` is applied uniformly to every attention block:
"vanilla" | "clipped_softmax" | "gated_attention".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.gating import GateConfig
from repro_torch.core.softmax import ClippedSoftmaxConfig
from repro_torch.models.transformer import ModelConfig


def apply_method(cfg: ModelConfig, method: str,
                 gamma: float = -0.03, alpha: Optional[float] = None,
                 zeta: float = 1.0, pi_init: float = 0.5,
                 gate_kind: str = "linear") -> ModelConfig:
    """Inject the paper's technique into any ModelConfig."""
    if method == "vanilla":
        return dataclasses.replace(
            cfg, softmax_cfg=ClippedSoftmaxConfig(), gate_cfg=GateConfig(kind="none"))
    if method == "clipped_softmax":
        sm = ClippedSoftmaxConfig(gamma=gamma, zeta=zeta, alpha=alpha)
        return dataclasses.replace(cfg, softmax_cfg=sm, gate_cfg=GateConfig(kind="none"))
    if method == "gated_attention":
        return dataclasses.replace(
            cfg, softmax_cfg=ClippedSoftmaxConfig(),
            gate_cfg=GateConfig.from_pi_init(pi_init, gate_kind))
    raise ValueError(f"unknown method {method!r}")

