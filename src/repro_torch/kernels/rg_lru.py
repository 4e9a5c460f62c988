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
because the tensors lie on the CPU. ``plan`` picks the kernel's route
from the shape and the alignment alone: route 1, a TMA ring in shared
memory (D % 4 == 0 and 16-byte aligned tensors, which the tensor maps
need), or route 0, direct loads (any D). Both round the product and the
sum of every step separately, in time order, as the plain loop does, so
both are bitwise equal to it. A route that cannot launch raises; it never
gives way to the other. The kernel has no backward: the wrapper refuses
inputs that need a gradient. ``launches`` counts kernel launches, and
nothing else.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels.build import load

# kernel launches made by ``rglru`` (plain integer)
launches = 0

_lib: Optional[ctypes.CDLL] = None

# route 1: a CTA owns 32 * warps channels of one row and walks T in tiles
# of 64 / warps steps (16 KB of a and b a ring slot, whatever the warps)
# through a ring of TMA_STAGES slots (``csrc/rg_lru.cu:STAGES``)
TMA_WARPS = (8, 4, 2, 1)
TMA_TILE_STEPS = 64
TMA_STAGES = 3
# route 1's dynamic shared memory a CTA (``csrc/rg_lru.cu:TMA_SMEM``): the
# ring, two h tiles of every consumer warp (16 KB in all), the full and
# empty barriers, 128 bytes of alignment slack
TMA_SMEM_BYTES = TMA_STAGES * 2 * TMA_TILE_STEPS * 32 * 4 + 2 * TMA_TILE_STEPS * 32 * 4 \
    + 2 * TMA_STAGES * 8 + 128
# route 0: 128 threads a CTA along D, loads issued 16 steps at a time
DIRECT_THREADS, DIRECT_STEPS = 128, 16


class Plan(NamedTuple):
    """How one call at (B, T, D) runs: ``route`` 1 (TMA ring) or 0
    (direct loads); ``warps`` consumer warps of a CTA (route 0: the CTA's
    warps); ``channels`` of one row a CTA owns; ``tile_t`` steps of a ring
    slot (route 0: of a load group); ``ctas`` of the grid; ``threads`` of
    a CTA; ``smem`` dynamic shared memory bytes of a CTA."""
    route: int
    warps: int
    channels: int
    tile_t: int
    ctas: int
    threads: int
    smem: int


def plan(b: int, t: int, d: int, sms: int, aligned: bool = True) -> Plan:
    """The static plan of a call on a card of ``sms`` SMs; ``aligned``:
    a, b and h start on 16-byte boundaries. Route 1 needs D % 4 == 0 (the
    tensor maps' row stride) and aligned tensors; route 0 takes the rest.
    Route 1 takes the widest strip (most warps) whose grid still covers
    one wave of the card, so a single long row runs D / 32 one-warp CTAs
    and a batch of rows fewer, wider ones. T does not enter: any T runs
    on either route (the chain stops at T)."""
    if d % 4 or not aligned:
        return Plan(0, DIRECT_THREADS // 32, DIRECT_THREADS, DIRECT_STEPS,
                    b * -(-d // DIRECT_THREADS), DIRECT_THREADS, 0)
    w = next((w for w in TMA_WARPS if b * -(-d // (32 * w)) >= sms), 1)
    return Plan(1, w, 32 * w, TMA_TILE_STEPS // w, b * -(-d // (32 * w)), 32 * w + 32,
                TMA_SMEM_BYTES)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("rg_lru")
        fn = lib.rglru_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
                           "torch.no_grad(). Its reverse scan comes with training "
                           "Griffin configs (ROADMAP 1.4)")
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
    p = plan(bsz, t, d, sm_count(a.device),
             aligned=all(x.data_ptr() % 16 == 0 for x in (a, b, h)))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel_lib().rglru_launch(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            h.data_ptr(), h_last.data_ptr(), bsz, t, d, p.route, p.warps, stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: cudaError {err} (plan {p})")
    global launches
    launches += 1
    return h, h_last
