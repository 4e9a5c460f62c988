"""Fake quantization (paper Eq. 1) on Hopper: the wrapper of the
hand-written CUDA kernel ``csrc/fake_quant.cu`` and its plain PyTorch
version.

Port of the Pallas TPU kernel ``repro/kernels/fake_quant.py :
fake_quant_pallas`` (oracle ``repro/kernels/ref.py : fake_quant_ref``).
Two forms of the same quant-dequant, chosen by ``ste``:

  * ``ste=False``, the TPU kernel's:
    ``s * (clip(round(x / s + z), 0, 2^b - 1) - z)``;
  * ``ste=True``, the form of every 'apply'-mode site of the model
    (``repro_torch.quant.quantizer.fake_quant``): x clipped to the
    representable range first, then ``x_clip + (qd - x_clip)``, whose
    gradient on the CPU is the straight-through estimator's.

Both compute in f32 and return x's dtype. ``s`` and ``z`` are python
floats or f32 tensors that broadcast against x: per-tensor, or (on the
card) per-channel along the last axis. ``fake_quant`` launches the kernel
for CUDA tensors, and raises if it cannot, and computes the plain
version ``fake_quant_ref`` for CPU tensors — only because the tensors lie
on the CPU. The kernel is bitwise the plain version. It has no backward:
on CUDA the wrapper refuses inputs that need a gradient. ``launches``
counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels.build import load

# kernel launches made by ``fake_quant`` (plain integer)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None

Scalar = Union[float, torch.Tensor]


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("fake_quant")
        fn = lib.fake_quant_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _f32(v: Scalar, device) -> torch.Tensor:
    """An f32 tensor on ``device``; a python number is made there (no
    host-to-device copy), and every divisor stays a tensor, so CUDA
    divides as the reference does."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def fake_quant_ref(x: torch.Tensor, s: Scalar, z: Scalar, bits: int = 8, *,
                   ste: bool = False) -> torch.Tensor:
    """The plain version, in both forms (see the module docstring)."""
    s, z = _f32(s, x.device), _f32(z, x.device)
    top = 2 ** bits - 1
    xf = x.float()
    if not ste:
        q = torch.clamp(torch.round(xf / s + z), 0, top)
        return (s * (q - z)).to(x.dtype)
    lo = s * (0.0 - z)
    hi = s * (top - z)
    x_clip = torch.minimum(torch.maximum(xf, lo), hi)
    qd = s * (torch.clamp(torch.round(x_clip / s + z), 0, top) - z)
    return (x_clip + (qd - x_clip).detach()).to(x.dtype)


def fake_quant(x: torch.Tensor, s: Scalar, z: Scalar, bits: int = 8, *,
               ste: bool = False) -> torch.Tensor:
    """Fused fake-quant: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. On the card ``s``/``z`` hold one value (per-tensor) or
    one per entry of x's last axis (per-channel)."""
    if x.device.type == "cpu":
        return fake_quant_ref(x, s, z, bits, ste=ste)
    if not x.is_cuda:
        raise ValueError(f"fake_quant: unsupported device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the fake-quant kernel has no backward: call it under "
                           "torch.no_grad(). No JAX path differentiates fake-quant (the "
                           "reference trains with NO_QUANT and has no quantization-aware "
                           "training loop), so the straight-through estimator has no kernel")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fake_quant takes float32 or bfloat16, got {x.dtype}")
    s, z = _f32(s, x.device).reshape(-1), _f32(z, x.device).reshape(-1)
    c = s.numel()
    if z.numel() != c or (c > 1 and (x.ndim == 0 or x.shape[-1] != c)):
        raise ValueError(f"s/z of {c} values fit neither per-tensor nor the last "
                         f"axis of x {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    s, z = s.contiguous(), z.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel_lib().fake_quant_launch(
            x.data_ptr(), out.data_ptr(), s.data_ptr(), z.data_ptr(), x.numel(), c,
            int(bits), int(ste), _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fake_quant kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out
