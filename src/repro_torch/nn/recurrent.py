"""RG-LRU and the Griffin/RecurrentGemma recurrent block (port of
``repro.nn.recurrent``; arXiv:2402.19427).

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)              # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)              # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)    # diagonal recurrence, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates are computed in f32 (``lambda`` is an f32 leaf even in a bf16
model). ``rglru_scan`` runs the recurrence over a block of T steps
through ``repro_torch.kernels.rg_lru.rglru``: the hand-written CUDA
kernel on the card, its plain sequential loop on the CPU. The reference
computes the same recurrence with an associative scan, which rounds in
another order (about 1e-7 apart in f32). Decode (one step with a state)
is ``rglru_step``, plain elementwise, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import rg_lru
from repro_torch.nn.layers import conv1d_apply, conv1d_init, linear_apply, linear_init
from repro_torch.nn.module import Params, split_keys
from repro_torch.quant.qconfig import NO_QUANT, QuantContext

_C = 8.0  # Griffin's fixed recurrence sharpness


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    width: int                 # recurrent width (= d_model for recurrentgemma)
    conv_width: int = 4
    a_init_min: float = 0.9    # Lambda init so a in [0.9, 0.999]
    a_init_max: float = 0.999


def rglru_init(gen: torch.Generator, cfg: RGLRUConfig, dtype=torch.float32) -> Params:
    ga, gx, gl = split_keys(gen, 3)
    std = 1.0 / math.sqrt(cfg.width)
    lo, hi = cfg.a_init_min ** 2, cfg.a_init_max ** 2
    u = torch.rand((cfg.width,), generator=gl, device=gl.device) * (hi - lo) + lo
    # Lambda such that exp(-c*softplus(Lambda)) = sqrt(u)
    softplus_val = -0.5 * torch.log(u) / _C
    lam = torch.log(torch.expm1(softplus_val))
    return {"w_a": linear_init(ga, cfg.width, cfg.width, std=std, dtype=dtype),
            "w_x": linear_init(gx, cfg.width, cfg.width, std=std, dtype=dtype),
            "lambda": lam.float()}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p: Params, x: torch.Tensor, ctx: QuantContext, name: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence, both f32 (B, T, D)."""
    r = torch.sigmoid(linear_apply(p["w_a"], x, ctx, name + "/w_a").float())
    i = torch.sigmoid(linear_apply(p["w_x"], x, ctx, name + "/w_x").float())
    log_a = -_C * _softplus(p["lambda"].float()) * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * x.float())
    return a, gated_x


def rglru_scan(p: Params, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
               ctx: QuantContext = NO_QUANT, name: str = "rglru"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block of T steps. x: (B, T, D) -> (y (B, T, D) in x's dtype,
    h_last (B, D) f32). The carried state ``h0`` enters as the kernel's
    initial state, which gives the bits of the reference's folding of
    ``a_0 * h0`` into the first step."""
    a, b = _gates(p, x, ctx, name)
    h, h_last = rg_lru.rglru(a, b, None if h0 is None else h0.float())
    return h.to(x.dtype), h_last


def rglru_step(p: Params, x_t: torch.Tensor, h: torch.Tensor,
               ctx: QuantContext = NO_QUANT, name: str = "rglru"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x_t: (B, D); h: (B, D) f32."""
    a, b = _gates(p, x_t[:, None, :], ctx, name)
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x_t.dtype), h_new


# --------------------------------------------------------------------------
# Griffin recurrent block: (linear, conv, RG-LRU) x (linear, GeLU) -> merge
# --------------------------------------------------------------------------
def griffin_block_init(gen: torch.Generator, d_model: int, cfg: RGLRUConfig,
                       dtype=torch.float32) -> Params:
    g1, g2, g3, g4, g5 = split_keys(gen, 5)
    return {
        "in_x": linear_init(g1, d_model, cfg.width, bias=False, dtype=dtype),
        "in_gate": linear_init(g2, d_model, cfg.width, bias=False, dtype=dtype),
        "conv": conv1d_init(g3, cfg.width, cfg.conv_width, dtype=dtype),
        "rglru": rglru_init(g4, cfg, dtype=dtype),
        "out": linear_init(g5, cfg.width, d_model, bias=False, dtype=dtype),
    }


def griffin_block_apply(
    p: Params, x: torch.Tensor, cfg: RGLRUConfig,
    state: Optional[dict] = None,
    ctx: QuantContext = NO_QUANT, name: str = "griffin",
) -> Tuple[torch.Tensor, dict]:
    """x: (B, T, D). state: {"h": (B, W) f32, "conv": (B, w-1, W)} or None.

    Returns (y, new_state); T = 1 with a state is one decode step. The
    gate's GeLU is the tanh approximation (``jax.nn.gelu``'s default)."""
    gate = F.gelu(linear_apply(p["in_gate"], x, ctx, name + "/in_gate"),
                  approximate="tanh")
    u = linear_apply(p["in_x"], x, ctx, name + "/in_x")
    conv_state = None if state is None else state["conv"]
    u, conv_state = conv1d_apply(p["conv"], u, conv_state)
    h0 = None if state is None else state["h"]
    if x.shape[1] == 1 and state is not None:
        y_r, h_last = rglru_step(p["rglru"], u[:, 0, :], h0, ctx, name + "/rglru")
        y_r = y_r[:, None, :]
    else:
        y_r, h_last = rglru_scan(p["rglru"], u, h0, ctx, name + "/rglru")
    merged = ctx.act(name + "/merged", y_r * gate)
    y = linear_apply(p["out"], merged, ctx, name + "/out")
    return y, {"h": h_last, "conv": conv_state}


def griffin_init_state(batch: int, cfg: RGLRUConfig, dtype=torch.float32,
                       device=None) -> dict:
    return {
        "h": torch.zeros((batch, cfg.width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.width), dtype=dtype,
                            device=device),
    }
