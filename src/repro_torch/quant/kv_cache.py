"""Int8 paged-KV quantization: per-slot scale vectors for the block pools
(port of ``repro.quant.kv_cache``).

With ``kv_int8=True`` the pools ``(num_blocks, block_size, Hkv, Dh)``
hold int8 and each pool block carries a scale vector
``(num_blocks, block_size)``: one f32 scale per token slot, symmetric
int8 over that token's (Hkv, Dh) values,

    scale = max|kv| / 127        q = round(kv / scale)

Each token is quantized exactly once, at write, so the stored bits are a
pure function of (token value, logical position): chunking, slot
assignment, preemption and prefix sharing stay bitwise invisible.
``torch.round`` rounds half to even like ``jnp.round``, so the codes
match the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

# symmetric int8 over [-127, 127]; scale floor keeps all-zero tokens exact
KV_QMAX = 127.0
KV_EPS = 1e-8


def kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``(..., Hkv, Dh)`` KV values to (int8 values, (...,) f32
    scales); the last two axes share one scale."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=(-2, -1))
    # divide by a tensor on amax's device: on CUDA, torch divides by a
    # python float as a multiplication by its reciprocal, which is not the
    # reference's f32 division
    qmax = torch.full((), KV_QMAX, dtype=torch.float32, device=amax.device)
    scale = torch.clamp(amax / qmax, min=KV_EPS)
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale


def kv_dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``kv_quant``: (..., Hkv, Dh) int8 + (...,) scales -> f32."""
    return q.float() * scale[..., None, None].float()
