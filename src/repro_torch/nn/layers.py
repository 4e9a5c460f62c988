"""Basic layers: linear, norms, embeddings (token and learned position),
rotary embeddings and the causal depthwise temporal conv (port of
``repro.nn.layers``).

Weights keep the JAX package's layout: a linear's ``w`` is (d_in, d_out)
and ``y = x @ w``. Its int8 codes ``w_q8`` keep that shape and the
reference's values, and are stored K-major ((d_out, d_in) in memory,
strides (1, d_in)), the layout the W8A8 kernel reads. Norms accumulate
in f32 whatever the compute dtype.
Every layer takes a ``QuantContext`` and a site name, with the
reference's sites (``name + ".in"``, ``".out"``, ``"#w"``); in 'int8'
mode a linear that carries ``w_q8`` runs the W8A8 kernel
(``_linear_int8_apply``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.nn.module import Params, normal_init
from repro_torch.quant.qconfig import NO_QUANT, QuantContext


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


def linear_apply(p: Params, x: torch.Tensor, ctx: QuantContext = NO_QUANT,
                 name: str = "linear") -> torch.Tensor:
    if ctx.mode == "int8" and "w_q8" in p:
        return _linear_int8_apply(p, x, ctx, name)
    w = ctx.weight(name, p["w"])
    x = ctx.act(name + ".in", x)
    if x.dtype != w.dtype:
        # mixed operands promote as in JAX (f32 @ bf16 -> f32): the plain
        # attention path returns f32 over a dequantized int8 KV pool
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return ctx.act(name + ".out", y)


def _linear_int8_apply(p: Params, x: torch.Tensor, ctx: QuantContext,
                       name: str) -> torch.Tensor:
    """Hardware W8A8 path: the pre-quantized ``w_q8``/``w_scale`` leaves
    and the STATIC per-tensor input range calibrated for this site (python
    floats, so the tick reads nothing back from the device); dynamic
    ranging only for a site calibration never saw. Returns f32, which
    promotes the residual stream as in the reference."""
    qp = ctx.act_qparams(name + ".in")
    s_x, z_x = qp if qp is not None else (None, None)
    lead = x.shape[:-1]
    y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), p["w_q8"],
                    p["w_scale"], x_scale=s_x, x_zero=z_x)
    y = y.reshape(*lead, p["w_q8"].shape[-1])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# --------------------------------------------------------------------------
# Norms — f32 accumulation regardless of compute dtype
# --------------------------------------------------------------------------
def layernorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6,
                    ctx: QuantContext = NO_QUANT, name: str = "ln") -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return ctx.act(name + ".out", (y * p["scale"].float() + p["bias"].float()).to(dt))


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6,
                  ctx: QuantContext = NO_QUANT, name: str = "rms",
                  zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm; ``zero_centered=True`` stores the scale as gamma-1."""
    dt = x.dtype
    xf = x.float()
    var = torch.square(xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = p["scale"].float()
    if zero_centered:
        scale = scale + 1.0
    return ctx.act(name + ".out", (y * scale).to(dt))


def norm_init(kind: str, d: int, dtype=torch.float32, device=None) -> Params:
    if kind == "layernorm":
        return layernorm_init(d, dtype, device)
    return rmsnorm_init(d, dtype, device)


def norm_apply(kind: str, p: Params, x: torch.Tensor, ctx: QuantContext = NO_QUANT,
               name: str = "norm", zero_centered: bool = False) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm_apply(p, x, ctx=ctx, name=name)
    return rmsnorm_apply(p, x, ctx=ctx, name=name, zero_centered=zero_centered)


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------
def embedding_init(gen: torch.Generator, vocab: int, d: int, std: float = 0.02,
                   dtype=torch.float32) -> Params:
    return {"table": normal_init(gen, (vocab, d), std, dtype)}


def embedding_apply(p: Params, ids: torch.Tensor, ctx: QuantContext = NO_QUANT,
                    name: str = "embed", scale: Optional[float] = None) -> torch.Tensor:
    table = ctx.weight(name, p["table"])
    y = table[ids]
    if scale is not None:
        y = y * torch.tensor(scale, dtype=y.dtype, device=y.device)
    return ctx.act(name + ".out", y)


def embedding_attend(p: Params, x: torch.Tensor, ctx: QuantContext = NO_QUANT,
                     name: str = "lm_head") -> torch.Tensor:
    """Tied-softmax output head: logits = x @ table^T, in f32."""
    table = ctx.weight(name, p["table"])
    x = ctx.act(name + ".in", x)
    return x.float() @ table.float().T


def positional_embedding_init(gen: torch.Generator, max_len: int, d: int,
                              dtype=torch.float32) -> Params:
    return {"table": normal_init(gen, (max_len, d), 0.02, dtype)}


def positional_embedding_apply(p: Params, positions: torch.Tensor) -> torch.Tensor:
    """Rows of the learned position table at ``positions`` ((T,) or (B,
    T)), with the reference's ``jnp.take`` fill semantics: a negative index
    counts from the end, and an index outside [-max_len, max_len) gives a
    row of NaN. The padded tail of a serving tick can carry positions past
    the table; no out-of-range index is ever issued (on the card it would
    be a device-side assert): the gather reads row 0 there and the row is
    replaced."""
    table = p["table"]
    n = table.shape[0]
    idx = torch.where(positions < 0, positions + n, positions)
    ok = (idx >= 0) & (idx < n)
    rows = table[torch.where(ok, idx, torch.zeros_like(idx))]
    nan = torch.full((), float("nan"), dtype=rows.dtype, device=rows.device)
    return torch.where(ok[..., None], rows, nan)


# --------------------------------------------------------------------------
# Rotary position embeddings (RoPE)
# --------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, d_head: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, shape (..., T, d_head/2), f32."""
    dev = positions.device
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=dev) / \
        torch.full((), d_head, dtype=torch.float32, device=dev)   # true f32 division on CUDA
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


# --------------------------------------------------------------------------
# Depthwise causal temporal conv (griffin)
# --------------------------------------------------------------------------
def conv1d_init(gen: torch.Generator, d: int, width: int, dtype=torch.float32) -> Params:
    return {"w": normal_init(gen, (width, d), 1.0 / math.sqrt(width), dtype),
            "b": torch.zeros((d,), dtype=dtype, device=gen.device)}


def conv1d_apply(p: Params, x: torch.Tensor, state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over time in x's dtype. x: (B, T, D);
    ``state``: the (B, width-1, D) history, cast to x's dtype (zeros when
    None). Returns (y, new_state)."""
    w = p["w"]
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xp[:, i:i + t] * w[i].to(x.dtype)
    y = y + p["b"].to(x.dtype)
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return y, new_state
