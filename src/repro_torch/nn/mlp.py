"""Feed-forward blocks (port of ``repro.nn.mlp``): the classic GELU/ReLU
MLP and the gated SwiGLU/GeGLU of the llama/qwen/gemma family."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import linear_apply, linear_init
from repro_torch.nn.module import Params, split_keys
from repro_torch.quant.qconfig import NO_QUANT, QuantContext


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: str = "gelu",
             dtype=torch.float32) -> Params:
    if kind in ("gelu", "gelu_tanh", "relu"):
        g1, g2 = split_keys(gen, 2)
        return {"up": linear_init(g1, d_model, d_ff, dtype=dtype),
                "down": linear_init(g2, d_ff, d_model, dtype=dtype)}
    if kind in ("swiglu", "geglu"):
        g1, g2, g3 = split_keys(gen, 3)
        return {"gate": linear_init(g1, d_model, d_ff, bias=False, dtype=dtype),
                "up": linear_init(g2, d_model, d_ff, bias=False, dtype=dtype),
                "down": linear_init(g3, d_ff, d_model, bias=False, dtype=dtype)}
    raise ValueError(f"unknown mlp kind {kind!r}")


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind in ("gelu", "geglu"):
        return F.gelu(x, approximate="none")
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    if kind == "swiglu":
        return F.silu(x)
    raise ValueError(kind)


def mlp_apply(p: Params, x: torch.Tensor, kind: str, ctx: QuantContext = NO_QUANT,
              name: str = "mlp") -> torch.Tensor:
    if kind in ("gelu", "gelu_tanh", "relu"):
        h = _act(kind, linear_apply(p["up"], x, ctx, name + "/up"))
        h = ctx.act(name + "/act.out", h)
        return linear_apply(p["down"], h, ctx, name + "/down")
    g = _act(kind, linear_apply(p["gate"], x, ctx, name + "/gate"))
    u = linear_apply(p["up"], x, ctx, name + "/up")
    h = ctx.act(name + "/act.out", g * u)
    return linear_apply(p["down"], h, ctx, name + "/down")
