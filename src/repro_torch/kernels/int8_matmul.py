"""W8A8 matmul on Hopper: the wrapper of the hand-written CUDA kernel
``csrc/int8_matmul.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/int8_matmul.py :
int8_matmul``. Activations get a per-tensor asymmetric uint8 range —
static ``(x_scale, x_zero)`` from calibration, or dynamic min/max of this
batch — and are centred and saturated to int8 [-127, 127]; weights are
per-tensor symmetric int8 ``(K, N)`` with an f32 scale; the product is
exact in int32 and dequantized by ``s_x * s_w`` into f32.

Weight layout: ``quantize_weights_int8`` returns the codes with the
reference's shape ``(K, N)`` and values, stored K-major (an ``(N, K)``
row-major tensor seen through ``.t()``, strides ``(1, K)``): both
tensor-core routes of the kernel read W^T rows, and ``wgmma`` takes 8-bit
operands K-major only. The kernel takes no other layout; ``_check``
refuses one rather than copy per call.

``int8_matmul`` launches the kernel for CUDA tensors (and raises if it
cannot) and computes the plain version for CPU tensors — only because
the tensors lie on the CPU. ``int8_matmul_ref`` is the plain version: the
reference's quantization in f32 and the integer product computed exactly
in float64 (|acc| <= 127^2 * K < 2^53), so kernel and plain version agree
bit for bit. ``launches`` counts kernel calls, and nothing else: one per
``int8_matmul`` on CUDA tensors, whose pre-pass (the activation codes)
and product are one call.

Every divisor is a tensor on the operand's device: torch on CUDA divides
by a host scalar as a multiplication by its reciprocal, which is not the
reference's f32 division.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels.build import load

# kernel launches made by ``int8_matmul`` (plain integer)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None

# route 0 (M <= 16): a CTA per 16-row weight strip
GEMV_MAX_M, GEMV_ROWS = 16, 16
# route 1 (M > 16): 128-row tiles
TC_BM = 128
# a 128-wide tile's time relative to half a 256-wide one's: the narrow
# tile reads as many code bytes for half the products. Measured on an H100
# at M 2048: a wave of 128-wide tiles takes 0.69 (K 17408) to 0.80 (K
# 5120) of a wave of 256-wide ones
TC_NARROW_COST = 1.4


class Plan(NamedTuple):
    """How one call at (M, N, K) runs: ``route`` 0 (mma.sync weight
    streaming, M <= 16) or 1 (TMA + wgmma, M > 16); ``tile_n`` the N tile
    (route 0: the 16-row strip); ``ctas`` the CTAs (route 1: persistent,
    at most one an SM); ``code_rows`` the rows of the codes scratch (8 or
    16 on route 0, M on route 1)."""
    route: int
    tile_n: int
    ctas: int
    code_rows: int


def plan(m: int, n: int, k: int, sms: int) -> Plan:
    """The static plan of a call on a card of ``sms`` SMs.

    Route 0 runs one CTA per 16-row weight strip. Route 1 takes the N
    tile (256 or 128) whose waves of persistent tiles cost least,
    counting a 128-wide tile as ``TC_NARROW_COST`` half tiles. Neither
    splits K across CTAs: on the card that measured slower at every
    decode shape and at M 2048, and no faster at (17, 5120, 5120)."""
    if m <= GEMV_MAX_M:
        return Plan(0, GEMV_ROWS, -(-n // GEMV_ROWS), 8 if m <= 8 else 16)
    tiles_m = -(-m // TC_BM)

    def cost(bn):
        return -(-(tiles_m * -(-n // bn)) // sms) * (1.0 if bn == 256 else 0.5 * TC_NARROW_COST)

    tile_n = 256 if cost(256) <= cost(128) else 128
    return Plan(1, tile_n, min(tiles_m * -(-n // tile_n), sms), m)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("int8_matmul")
        fn = lib.int8_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _const(v: float, device) -> torch.Tensor:
    """An f32 scalar on ``device``, made there (no host-to-device copy)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def empty_k_major(shape, device) -> torch.Tensor:
    """Uninitialized int8 codes of ``shape`` (..., K, N), stored K-major:
    an (..., N, K) row-major array seen with its last two axes swapped.
    Every maker of ``w_q`` allocates through this; slicing leading axes
    keeps the layout."""
    *lead, k, n = shape
    return torch.empty((*lead, n, k), dtype=torch.int8, device=device).transpose(-1, -2)


def quantize_weights_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 weight quantization (paper C.4): returns
    (int8 codes, f32 scalar scale) on ``w``'s device. The codes have
    ``w``'s shape (K, N) and are stored K-major (strides (1, K))."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf))
    scale = torch.clamp(amax / _const(127.0, w.device), min=1e-8)
    wq = empty_k_major(w.shape, w.device)
    wq.copy_(torch.clamp(torch.round(wf / scale), -127, 127))
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


def k_major(w_q: torch.Tensor) -> bool:
    """Is the (K, N) ``w_q`` stored K-major (an (N, K) row-major array)?"""
    return w_q.dim() == 2 and w_q.stride() == (1, w_q.shape[0])


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
    if not x.is_contiguous() or not w_scale.is_contiguous():
        raise ValueError("x and w_scale must be contiguous")
    if not k_major(w_q):
        raise ValueError(f"w_q must be stored K-major (strides (1, K) = (1, "
                         f"{w_q.shape[0]})), got strides {tuple(w_q.stride())}: make "
                         f"it with quantize_weights_int8")
    m, k = x.shape
    n = w_q.shape[1]
    if m < 1 or k % 16 or n % 16:
        raise ValueError(f"(M, K, N) = ({m}, {k}, {n}): the kernel takes M >= 1 "
                         f"and K, N multiples of 16 (16-byte row loads)")
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("x and w_q must be 16-byte aligned")


def _launch(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
            x_scale: Optional[float], x_zero: Optional[float]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel call on CUDA tensors, as ``plan`` routes it: (out (M, N)
    f32, the pre-pass's codes scratch (code_rows, K) int8)."""
    _check(x, w_q, w_scale)
    m, k = x.shape
    n = w_q.shape[1]
    dev = x.device
    p = plan(m, n, k, sm_count(dev))
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        codes = torch.empty((p.code_rows, k), dtype=torch.int8, device=dev)
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
            codes.data_ptr(), p.code_rows, out.data_ptr(),
            m, n, k, _DTYPE_CODE[x.dtype], p.route, p.tile_n, p.ctas, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err} "
                           f"(plan {p})")
    global launches
    launches += 1
    return out, codes


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
                x_scale: Optional[float] = None,
                x_zero: Optional[float] = None) -> torch.Tensor:
    """W8A8 matmul: the CUDA kernel on CUDA tensors (``w_q`` K-major, as
    ``quantize_weights_int8`` makes it), the plain version on CPU
    tensors. Static ``x_scale``/``x_zero`` (python floats, e.g. from
    ``QuantContext.act_qparams``) pass by value; without them the range
    of this batch is computed on the device. Returns (M, N) f32."""
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_q, w_scale, x_scale=x_scale, x_zero=x_zero)
    if not x.is_cuda:
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return _launch(x, w_q, w_scale, x_scale, x_zero)[0]
