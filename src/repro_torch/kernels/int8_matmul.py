"""W8A8 matmul on Hopper: the wrapper of the hand-written CUDA kernel
``csrc/int8_matmul.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/int8_matmul.py :
int8_matmul``. Activations get a per-tensor asymmetric uint8 range —
static ``(x_scale, x_zero)`` from calibration, or dynamic min/max of this
batch — and are centred and saturated to int8 [-127, 127]; weights are
per-tensor symmetric int8 ``(K, N)`` with an f32 scale; the product is
exact in int32 and dequantized by ``s_x * s_w`` into f32.

``int8_matmul`` launches the kernel for CUDA tensors (and raises if it
cannot) and computes the plain version for CPU tensors — only because
the tensors lie on the CPU. ``int8_matmul_ref`` is the plain version: the
reference's quantization in f32 and the integer product computed exactly
in float64 (|acc| <= 127^2 * K < 2^53), so kernel and plain version agree
bit for bit. ``launches`` counts kernel launches, and nothing else.

Every divisor is a tensor on the operand's device: torch on CUDA divides
by a host scalar as a multiplication by its reciprocal, which is not the
reference's f32 division.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import load

# kernel launches made by ``int8_matmul`` (plain integer)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("int8_matmul")
        fn = lib.int8_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        ws = lib.int8_matmul_workspace_elems
        ws.argtypes = [ctypes.c_int] * 3
        ws.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _const(v: float, device) -> torch.Tensor:
    """An f32 scalar on ``device``, made there (no host-to-device copy)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def quantize_weights_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 weight quantization (paper C.4): returns
    (int8 codes, f32 scalar scale) on ``w``'s device."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf))
    scale = torch.clamp(amax / _const(127.0, w.device), min=1e-8)
    wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return wq, scale


def activation_qparams(x: torch.Tensor, x_scale: Optional[float] = None,
                       x_zero: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s_x, z_x) as f32 scalars on ``x``'s device: the static pair, or
    the dynamic per-tensor range of ``x`` (nudged to include 0), computed
    on the device without a host sync."""
    dev = x.device
    if x_scale is not None:
        return _const(float(x_scale), dev), _const(0.0 if x_zero is None else float(x_zero), dev)
    lo, hi = torch.aminmax(x)
    x_min = torch.clamp(lo.float(), max=0.0)
    x_max = torch.clamp(hi.float(), min=0.0)
    s = torch.clamp((x_max - x_min) / _const(255.0, dev), min=1e-8)
    z = torch.clamp(torch.round(-x_min / s), 0, 255)
    return s, z


def quantize_activations(x: torch.Tensor, s_x: torch.Tensor, z_x: torch.Tensor
                         ) -> torch.Tensor:
    """int8 codes ``clip(clip(round(x / s) + z, 0, 255) - z, -127, 127)``."""
    q = torch.clamp(torch.round(x.float() / s_x) + z_x, 0, 255) - z_x
    return torch.clamp(q, -127, 127).to(torch.int8)


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
                    x_scale: Optional[float] = None,
                    x_zero: Optional[float] = None) -> torch.Tensor:
    """The plain version: (M, K) f32/bf16 x, (K, N) int8 w_q, f32 scalar
    w_scale -> (M, N) f32."""
    s_x, z_x = activation_qparams(x, x_scale, x_zero)
    codes = quantize_activations(x, s_x, z_x)
    acc = codes.double() @ w_q.double()
    return acc.float() * (s_x * w_scale.float())


def _check(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be a 2-D float32 or bfloat16 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if w_q.dim() != 2 or w_q.dtype != torch.int8 or w_q.shape[0] != x.shape[1]:
        raise TypeError(f"w_q must be int8 ({x.shape[1]}, N), got {w_q.dtype} "
                        f"{tuple(w_q.shape)}")
    if w_scale.dtype != torch.float32 or w_scale.numel() != 1:
        raise TypeError("w_scale must be one float32 value")
    for n, t in (("x", x), ("w_q", w_q), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"{n} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    m, k = x.shape
    n = w_q.shape[1]
    if m < 1 or k % 16 or n % 16:
        raise ValueError(f"(M, K, N) = ({m}, {k}, {n}): the kernel takes M >= 1 "
                         f"and K, N multiples of 16 (16-byte row loads)")
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("x and w_q must be 16-byte aligned")


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
                x_scale: Optional[float] = None,
                x_zero: Optional[float] = None) -> torch.Tensor:
    """W8A8 matmul: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Static ``x_scale``/``x_zero`` (python floats, e.g. from
    ``QuantContext.act_qparams``) pass by value; without them the range
    of this batch is computed on the device. Returns (M, N) f32."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_q, w_scale, x_scale=x_scale, x_zero=x_zero)
    if not x.is_cuda:
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    _check(x, w_q, w_scale)
    m, k = x.shape
    n = w_q.shape[1]
    dev = x.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        ws = None
        ws_elems = lib.int8_matmul_workspace_elems(m, n, k)
        if ws_elems:
            ws = torch.empty((ws_elems,), dtype=torch.int32, device=dev)
        s_x = z_x = None
        if x_scale is None:
            s_x, z_x = activation_qparams(x)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.int8_matmul_launch(
            x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
            None if s_x is None else s_x.data_ptr(),
            None if z_x is None else z_x.data_ptr(),
            0.0 if x_scale is None else float(x_scale),
            0.0 if x_zero is None else float(x_zero),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            m, n, k, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out
