"""Gating modules for gated attention, paper Section 4.2 (port of
``repro.core.gating``).

Gated_attention(x) = sigmoid(G(x)) ⊙ softmax(QK^T/sqrt(d)) V        (Eq. 5)

G is per head, shared across positions: "linear" (n_heads × Linear(d_head
-> 1)), "mlp" (n_heads × MLP(d_head -> n_hid -> 1)) or "all_heads_linear"
(Linear(d_model -> n_heads)). The bias starts at ``b_init`` so the initial
gate probability is sigmoid(b_init).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.nn.module import split_keys

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GateConfig:
    kind: str = "linear"          # "linear" | "mlp" | "all_heads_linear" | "none"
    n_hid: int = 4                # hidden width for the "mlp" kind
    b_init: float = 0.0           # gate bias init; pi_init = sigmoid(b_init)
    output_scale: float = 1.0     # 2.0 for the fine-tuning recipe (App. B.6)

    @property
    def enabled(self) -> bool:
        return self.kind != "none"

    @staticmethod
    def from_pi_init(pi_init: float, kind: str = "linear", **kw) -> "GateConfig":
        pi = min(max(pi_init, 1e-6), 1.0 - 1e-6)
        return GateConfig(kind=kind, b_init=math.log(pi / (1.0 - pi)), **kw)


def _he_normal(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    std = math.sqrt(2.0 / max(fan_in, 1))
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (std * x).to(dtype)


def init_gate(gen: torch.Generator, cfg: GateConfig, n_heads: int, d_head: int,
              d_model: int, dtype=torch.float32) -> Params:
    """Parameter dict of the gating module; empty if disabled."""
    if not cfg.enabled:
        return {}
    b = torch.full((n_heads,), cfg.b_init, dtype=dtype, device=gen.device)
    if cfg.kind == "linear":
        return {"w": _he_normal(gen, (n_heads, d_head), d_head, dtype), "b": b}
    if cfg.kind == "mlp":
        g1, g2 = split_keys(gen, 2)
        return {
            "w1": _he_normal(g1, (n_heads, d_head, cfg.n_hid), d_head, dtype),
            "b1": torch.zeros((n_heads, cfg.n_hid), dtype=dtype, device=gen.device),
            "w2": _he_normal(g2, (n_heads, cfg.n_hid), cfg.n_hid, dtype),
            "b2": b,
        }
    if cfg.kind == "all_heads_linear":
        return {"w": _he_normal(gen, (d_model, n_heads), d_model, dtype), "b": b}
    raise ValueError(f"unknown gate kind: {cfg.kind!r}")


def _einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum with JAX's promotion of mixed operands (f32 with bf16 -> f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.einsum(eq, x.to(dt), w.to(dt))


def gate_logits(params: Params, cfg: GateConfig, x_heads: torch.Tensor,
                x_model: torch.Tensor) -> torch.Tensor:
    """Raw gate logits G(x), shape (..., T, n_heads).

    ``x_heads``: (..., T, n_heads, d_head); ``x_model``: (..., T, d_model)."""
    if cfg.kind == "linear":
        return _einsum("...thd,hd->...th", x_heads, params["w"]) + params["b"]
    if cfg.kind == "mlp":
        h = _einsum("...thd,hdn->...thn", x_heads, params["w1"]) + params["b1"]
        h = torch.relu(h)
        return _einsum("...thn,hn->...th", h, params["w2"]) + params["b2"]
    if cfg.kind == "all_heads_linear":
        return _einsum("...td,dh->...th", x_model, params["w"]) + params["b"]
    raise ValueError(f"unknown gate kind: {cfg.kind!r}")


def gate_probs(params: Params, cfg: GateConfig, x_heads: torch.Tensor,
               x_model: torch.Tensor) -> torch.Tensor:
    """pi = output_scale * sigmoid(G(x)), shape (..., T, n_heads)."""
    pi = torch.sigmoid(gate_logits(params, cfg, x_heads, x_model))
    if cfg.output_scale != 1.0:
        pi = cfg.output_scale * pi
    return pi


def gate_param_count(cfg: GateConfig, n_heads: int, d_head: int, d_model: int) -> int:
    """Parameters the gate adds (the memory overhead of paper Table 4)."""
    if not cfg.enabled:
        return 0
    if cfg.kind == "linear":
        return n_heads * (d_head + 1)
    if cfg.kind == "mlp":
        return n_heads * (cfg.n_hid * (d_head + 2) + 1)
    if cfg.kind == "all_heads_linear":
        return n_heads * (d_model + 1)
    raise ValueError(cfg.kind)
