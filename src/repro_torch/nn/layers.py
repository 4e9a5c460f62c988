"""Basic layers: linear, norms, embeddings, rotary embeddings (port of
``repro.nn.layers``, fp path).

Weights keep the JAX package's layout: a linear's ``w`` is (d_in, d_out)
and ``y = x @ w``. Norms accumulate in f32 whatever the compute dtype.
The W8A8 linear (``_linear_int8_apply`` over the ``int8_matmul`` kernel)
is the next slice of the port.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.nn.module import Params, normal_init


# --------------------------------------------------------------------------
# Linear
# --------------------------------------------------------------------------
def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = True, std: Optional[float] = None,
                dtype=torch.float32) -> Params:
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal_init(gen, (d_in, d_out), std, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    if x.dtype != w.dtype:
        # mixed operands promote as in JAX (f32 @ bf16 -> f32): the plain
        # attention path returns f32 over a dequantized int8 KV pool
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# --------------------------------------------------------------------------
# Norms — f32 accumulation regardless of compute dtype
# --------------------------------------------------------------------------
def layernorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6,
                  zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm; ``zero_centered=True`` stores the scale as gamma-1."""
    dt = x.dtype
    xf = x.float()
    var = torch.square(xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = p["scale"].float()
    if zero_centered:
        scale = scale + 1.0
    return (y * scale).to(dt)


def norm_init(kind: str, d: int, dtype=torch.float32, device=None) -> Params:
    if kind == "layernorm":
        return layernorm_init(d, dtype, device)
    return rmsnorm_init(d, dtype, device)


def norm_apply(kind: str, p: Params, x: torch.Tensor,
               zero_centered: bool = False) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm_apply(p, x)
    return rmsnorm_apply(p, x, zero_centered=zero_centered)


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------
def embedding_init(gen: torch.Generator, vocab: int, d: int, std: float = 0.02,
                   dtype=torch.float32) -> Params:
    return {"table": normal_init(gen, (vocab, d), std, dtype)}


def embedding_apply(p: Params, ids: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    y = p["table"][ids]
    if scale is not None:
        y = y * torch.tensor(scale, dtype=y.dtype, device=y.device)
    return y


def embedding_attend(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied-softmax output head: logits = x @ table^T, in f32."""
    return x.float() @ p["table"].float().T


# --------------------------------------------------------------------------
# Rotary position embeddings (RoPE)
# --------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, d_head: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, shape (..., T, d_head/2), f32."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=positions.device) / d_head
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, T, H, D); cos/sin: (T, D/2) or (B, T, D/2)."""
    dt = x.dtype
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if cos.ndim == 2:     # (T, D/2) -> broadcast over batch and heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:                 # (B, T, D/2)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dt)
