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
gives way to the other. ``launches`` counts kernel launches, and nothing
else.

The gradient: inputs that need one go through ``RGLRU`` (a
``torch.autograd.Function``) on every device. Its forward is the call
above; it keeps a, h and h0. Its backward is the reverse scan, the
kernel's second entry point ``rglru_bwd_launch`` on CUDA tensors
(``bwd_launches`` counts its launches) and the plain reverse loop
``rglru_bwd_ref`` on CPU tensors: with g_T = dh_T + dh_last and g_t = dh_t
+ a_{t+1} g_{t+1}, db_t = g_t, da_t = g_t h_{t-1} (h_0 = h0 or 0) and dh0
= a_1 g_1, each product and sum rounded on its own, so the kernel is
bitwise the loop, and the loop bitwise torch autograd through
``rglru_ref``. ``plan_bwd`` picks the reverse scan's route as ``plan``
does: route 1, the TMA ring walked backwards (D % 4 == 0 and a, h, dh, da
and db 16-byte aligned), or route 0, direct loads; neither gives way to
the other. (The reference has no such kernel: XLA differentiates its
scan.)
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels.build import load

# kernel launches made by ``rglru`` (plain integer)
launches = 0
# reverse-scan kernel launches made by ``RGLRU.backward`` on the card
bwd_launches = 0

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
# the reverse scan's route 1: a CTA owns 32 channels of one row (one
# consumer warp) and walks T backwards in tiles of 32 steps (12 KB of a, dh
# and h a ring slot) through a ring of BWD_STAGES slots
# (``csrc/rg_lru.cu:BWD_WARPS``, ``BWD_TILE``, ``BWD_STAGES``)
BWD_WARPS = 1
BWD_TILE_STEPS = 32
BWD_STAGES = 3
# its dynamic shared memory a CTA (``csrc/rg_lru.cu:BWD_SMEM``): the ring,
# two da and two db tiles of the consumer warp (16 KB), the full and empty
# barriers, 128 bytes of alignment slack
BWD_SMEM_BYTES = BWD_STAGES * 3 * BWD_TILE_STEPS * 32 * 4 + 4 * BWD_TILE_STEPS * 32 * 4 \
    + 2 * BWD_STAGES * 8 + 128


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


def _direct_plan(b: int, d: int) -> Plan:
    """Route 0: direct loads, 128 channels a CTA."""
    return Plan(0, DIRECT_THREADS // 32, DIRECT_THREADS, DIRECT_STEPS,
                b * -(-d // DIRECT_THREADS), DIRECT_THREADS, 0)


def plan(b: int, t: int, d: int, sms: int, aligned: bool = True) -> Plan:
    """The static plan of a call on a card of ``sms`` SMs; ``aligned``:
    a, b and h start on 16-byte boundaries. Route 1 needs D % 4 == 0 (the
    tensor maps' row stride) and aligned tensors; route 0 takes the rest.
    Route 1 takes the widest strip (most warps) whose grid still covers
    one wave of the card, so a single long row runs D / 32 one-warp CTAs
    and a batch of rows fewer, wider ones. T does not enter: any T runs
    on either route (the chain stops at T)."""
    if d % 4 or not aligned:
        return _direct_plan(b, d)
    w = next((w for w in TMA_WARPS if b * -(-d // (32 * w)) >= sms), 1)
    return Plan(1, w, 32 * w, TMA_TILE_STEPS // w, b * -(-d // (32 * w)), 32 * w + 32,
                TMA_SMEM_BYTES)


def plan_bwd(b: int, t: int, d: int, aligned: bool = True) -> Plan:
    """The reverse scan's static plan; ``aligned``: a, h, dh, da and db
    start on 16-byte boundaries. Route 1, the ring walked backwards, for D
    % 4 == 0 and aligned tensors, one warp a CTA at every B (the reverse
    scan runs in training, at B 1, so the card's size does not enter);
    route 0, direct loads, for the rest. T does not enter (the chain
    starts at T - 1)."""
    if d % 4 or not aligned:
        return _direct_plan(b, d)
    ch = 32 * BWD_WARPS
    return Plan(1, BWD_WARPS, ch, BWD_TILE_STEPS // BWD_WARPS, b * -(-d // ch), ch + 32,
                BWD_SMEM_BYTES)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("rg_lru")
        fn = lib.rglru_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.rglru_bwd_launch
        bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
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


def rglru_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                  dh_last: Optional[torch.Tensor] = None, h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The plain reverse scan: a loop over T backwards carrying c = a_{t+1}
    g_{t+1} (dh_last at first): g = dh_t + c, db_t = g, da_t = g h_{t-1}
    (h0 or 0 at t = 0), c = a_t g, in f32. a, h (the forward's output), dh
    (B, T, D); dh_last, h0 (B, D) or None. Returns (da, db, dh0), dh0 None
    without h0."""
    a, h, dh = a.float(), h.float(), dh.float()
    bsz, t, d = a.shape
    c = torch.zeros((bsz, d), dtype=torch.float32, device=a.device) \
        if dh_last is None else dh_last.float()
    h_init = torch.zeros_like(c) if h0 is None else h0.float()
    da, db = torch.empty_like(a), torch.empty_like(a)
    for i in range(t - 1, -1, -1):
        g = dh[:, i] + c
        db[:, i] = g
        da[:, i] = g * (h[:, i - 1] if i > 0 else h_init)
        c = a[:, i] * g
    return da, db, (None if h0 is None else c)


def _check(seqs, states):
    """Raise unless the named (B, T, D) tensors of ``seqs`` (T >= 1) and
    (B, D) tensors of ``states`` (None allowed) are f32 on the first one's
    device."""
    first = next(iter(seqs.values()))
    if first.ndim != 3 or first.shape[1] < 1 or any(x.shape != first.shape
                                                     for x in seqs.values()):
        raise ValueError(f"{', '.join(f'{n} {tuple(x.shape)}' for n, x in seqs.items())} "
                         f"must all be (B, T, D) with T >= 1")
    bsz, _, d = first.shape
    for name, x in states.items():
        if x is not None and tuple(x.shape) != (bsz, d):
            raise ValueError(f"{name} must be {(bsz, d)}, got {tuple(x.shape)}")
    for name, x in (*seqs.items(), *states.items()):
        if x is not None and (x.dtype != torch.float32 or x.device != first.device):
            raise TypeError(f"{name} must be float32 on {first.device}, got {x.dtype} "
                            f"on {x.device}")


def _forward(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence without a gradient: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if not a.is_cuda:
        if a.device.type != "cpu":
            raise ValueError(f"rglru: unsupported device {a.device}")
        return rglru_ref(a, b, h0)
    _check(dict(a=a, b=b), dict(h0=h0))
    bsz, t, d = a.shape
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


def _launch_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor, dh_last: torch.Tensor,
                h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The reverse-scan kernel over CUDA tensors: a, h, dh (B, T, D),
    dh_last (B, D), h0 (B, D) or None, all f32 on one device. Returns (da,
    db, dh0) as new contiguous tensors (dh0 None without h0)."""
    _check(dict(a=a, h=h, dh=dh), dict(dh_last=dh_last, h0=h0))
    bsz, t, d = a.shape
    a, h, dh, dh_last = (x.contiguous() for x in (a, h, dh, dh_last))
    h0 = None if h0 is None else h0.contiguous()
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    p = plan_bwd(bsz, t, d, aligned=all(x.data_ptr() % 16 == 0 for x in (a, h, dh, da, db)))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel_lib().rglru_bwd_launch(
            a.data_ptr(), h.data_ptr(), dh.data_ptr(), dh_last.data_ptr(), ptr(h0),
            da.data_ptr(), db.data_ptr(), ptr(dh0), bsz, t, d, p.route, stream)
    if err != 0:
        raise RuntimeError(f"rglru reverse-scan kernel launch failed: cudaError {err} "
                           f"(plan {p})")
    global bwd_launches
    bwd_launches += 1
    return da, db, dh0


class RGLRU(torch.autograd.Function):
    """The recurrence with its gradient. Forward: ``_forward`` (the kernel
    on CUDA tensors, ``rglru_ref`` on CPU ones); it keeps a, h and h0.
    Backward: the reverse-scan kernel on CUDA tensors (``_launch_bwd``),
    ``rglru_bwd_ref`` on CPU ones; returns (da, db, dh0)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = _forward(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        if a.is_cuda:
            da, db, dh0 = _launch_bwd(a, h, dh, dh_last, h0)
        else:
            da, db, dh0 = rglru_bwd_ref(a, h, dh, dh_last, h0)
        return da, db, dh0


def rglru(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors; inputs that need a gradient go through ``RGLRU``. a, b
    (B, T, D) f32; h0 (B, D) f32 or None."""
    if a.device.type == "meta":  # shapes only (the dry-run): the plain math
        return rglru_ref(a, b, h0)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (a, b, h0)):
        return RGLRU.apply(a, b, h0)
    return _forward(a, b, h0)
