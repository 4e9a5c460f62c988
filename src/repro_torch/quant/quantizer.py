"""Uniform affine quantization simulation (port of
``repro.quant.quantizer``; paper Section 2, Eq. 1).

    q(x; s, z, b) = s * (clip(round(x / s) + z, 0, 2^b - 1) - z)

Asymmetric (affine) quantization for activations, symmetric for weights,
simulated in f32 with a straight-through estimator. The arithmetic is the
JAX package's, step by step, in f32: ``torch.round`` rounds half to even
like ``jnp.round``, and every divisor is a tensor on the operand's device
(on CUDA, torch divides by a host scalar as a multiplication by its
reciprocal, which is not the same f32 division).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.fake_quant import fake_quant as fake_quant_kernel


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantizer."""

    bits: int = 8
    symmetric: bool = False       # True for weights, False for activations
    per_channel_axis: Optional[int] = None  # None = per-tensor (paper default)

    @property
    def n_levels(self) -> int:
        return 2 ** self.bits


def _f32(x, device=None) -> torch.Tensor:
    """``x`` as an f32 tensor; a python number is made on ``device`` (no
    host-to-device copy)."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def scale_zero_point(x_min, x_max, spec: QuantSpec, eps: float = 1e-8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale s and zero-point z (f32) from a (min, max) range.

    Symmetric: z = 2^(b-1) (mid level), dequantized grid
    s * [-2^(b-1), 2^(b-1)-1]. Asymmetric: uniform affine with the range
    nudged to include 0."""
    x_min = _f32(x_min)
    x_max = _f32(x_max, x_min.device)
    n = spec.n_levels
    if spec.symmetric:
        amax = torch.maximum(torch.abs(x_min), torch.abs(x_max))
        s = torch.clamp(amax / _f32(n / 2 - 1, amax.device), min=eps)
        z = torch.full_like(s, n // 2)
    else:
        x_min = torch.clamp(x_min, max=0.0)   # range must include zero
        x_max = torch.clamp(x_max, min=0.0)
        s = torch.clamp((x_max - x_min) / _f32(n - 1, x_min.device), min=eps)
        z = torch.clamp(torch.round(-x_min / s), 0, n - 1)
    return s, z


def _broadcast(s, z, ndim: int, spec: QuantSpec):
    if spec.per_channel_axis is None:
        return s, z
    shape = [1] * ndim
    shape[spec.per_channel_axis] = -1
    return s.reshape(shape), z.reshape(shape)


def quantize(x: torch.Tensor, s, z, spec: QuantSpec) -> torch.Tensor:
    """x -> integer grid (int32) via Eq. 1, without dequantization."""
    s, z = _broadcast(_f32(s, x.device), _f32(z, x.device), x.ndim, spec)
    q = torch.round(x.float() / s) + z
    return torch.clamp(q, 0, spec.n_levels - 1).to(torch.int32)


def dequantize(q: torch.Tensor, s, z, spec: QuantSpec) -> torch.Tensor:
    s, z = _broadcast(_f32(s, q.device), _f32(z, q.device), q.ndim, spec)
    return (s * (q.float() - z)).float()


def fake_quant(x: torch.Tensor, s, z, spec: QuantSpec) -> torch.Tensor:
    """Simulated quantization q(x) (Eq. 1) with a straight-through
    gradient: identity inside the representable range, zero for clipped
    values. x is clipped to the range, then ``x_clip + (qd - x_clip)`` in
    f32, cast to x's dtype (``kernels.fake_quant``'s ``ste`` form). CUDA
    tensors go to the hand-written kernel (per-tensor, or per-channel along
    the last axis), CPU tensors to its plain version; the two are bitwise
    equal."""
    if x.is_cuda and spec.per_channel_axis not in (None, x.ndim - 1):
        raise NotImplementedError(
            f"the fake-quant kernel takes per-channel ranges along the last "
            f"axis only, not axis {spec.per_channel_axis} of a {x.ndim}-d tensor")
    s_b, z_b = _broadcast(_f32(s, x.device), _f32(z, x.device), x.ndim, spec)
    return fake_quant_kernel(x, s_b, z_b, spec.bits, ste=True)


def quantization_error(x: torch.Tensor, s, z, spec: QuantSpec) -> torch.Tensor:
    """Mean squared error of fake-quantizing x (the MSE estimator's
    objective)."""
    return torch.mean((x.float() - fake_quant(x, s, z, spec).float()) ** 2)
