"""The RG-LRU linear recurrence on Hopper: the wrapper of the hand-written
CUDA kernel ``csrc/rg_lru.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/rg_lru.py : rglru_pallas``
(oracle ``repro/kernels/ref.py : rglru_ref``): the diagonal recurrence

    h_t = a_t * h_{t-1} + b_t,   a, b (B, T, D); h0 (B, D) or None (zeros)

in f32, returning (h (B, T, D), h_last (B, D)), so that a sequence cut
into chunks carries its state from one call to the next. Griffin's
``rglru_scan`` (``repro_torch.nn.recurrent``) runs its recurrence here.

``rglru`` launches the kernel for CUDA tensors, and raises if it cannot,
and computes the plain version ``rglru_ref`` for CPU tensors — only
because the tensors lie on the CPU. The kernel rounds the product and the
sum of every step separately, as the plain loop does, so the two are
bitwise equal. It has no backward: the wrapper refuses inputs that need a
gradient. ``launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import load

# kernel launches made by ``rglru`` (plain integer)
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("rg_lru")
        fn = lib.rglru_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def rglru_ref(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a loop over T of ``a[:, t] * h + b[:, t]`` in f32."""
    a, b = a.float(), b.float()
    bsz, t, d = a.shape
    h = torch.zeros((bsz, d), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    outs = []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        outs.append(h)
    return torch.stack(outs, dim=1), h


def rglru(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. a, b (B, T, D) f32; h0 (B, D) f32 or None."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (a, b, h0)):
        raise RuntimeError("the RG-LRU kernel has no backward yet: call it under "
                           "torch.no_grad() (training is not ported)")
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"rglru: unsupported device {a.device}")
        return rglru_ref(a, b, h0)
    if a.ndim != 3 or b.shape != a.shape or a.shape[1] < 1:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must both be "
                         f"(B, T, D) with T >= 1")
    bsz, t, d = a.shape
    if h0 is not None and tuple(h0.shape) != (bsz, d):
        raise ValueError(f"h0 must be {(bsz, d)}, got {tuple(h0.shape)}")
    for name, x in (("a", a), ("b", b), ("h0", h0)):
        if x is not None and (x.dtype != torch.float32 or x.device != a.device):
            raise TypeError(f"{name} must be float32 on {a.device}, got {x.dtype} "
                            f"on {x.device}")
    a, b = a.contiguous(), b.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    h = torch.empty_like(a)
    h_last = torch.empty((bsz, d), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel_lib().rglru_launch(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            h.data_ptr(), h_last.data_ptr(), bsz, t, d, stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return h, h_last
