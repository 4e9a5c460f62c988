"""Paged attention on Hopper: the wrapper of the hand-written CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/paged_attention.py :
paged_flash_attention`` (adapter ``paged_mha``). Same layout and
semantics: q ``(B, Hkv, Tq*G, Dh)`` head-packed (query row r is token
r // G, head lane r % G), pools ``(NB, BS, Hkv, Dh)`` read in place
through a per-row block table with a per-row ``q_off``; causal and
window masks over logical positions; ``-1`` entries masked; logit
softcap; vanilla softmax in one online pass, the clipped softmax in two
passes ((m, Z), then ``clip((zeta-gamma)*p+gamma, 0, 1) @ V``); the gate
multiplies the output; int8 pools carry per-slot ``(NB, BS)`` scales.
f32 queries may read a bf16 pool. The plain version computes everything
in f32; the kernel accumulates in f32 (its tensor-core route multiplies
bf16 data exactly and carries P at f32 precision as two bf16 operands);
the output has q's dtype. ``gamma`` arrives already
resolved from the logical length; nothing here recomputes it. ``live_widths`` lets each row stop
at its own block count; masked entries contribute exact zeros, so that
early exit is exact. A row with nothing live outputs exact zeros.

``paged_flash_attention`` launches the kernel for CUDA tensors (and
raises if it cannot) and computes the plain version for CPU tensors —
only because the tensors lie on the CPU. ``paged_flash_attention_ref`` is
the plain version: a straight gather-and-dense translation, used by the
CPU tests and by ``chip_smoke.py`` to hold the kernel on the card.
``plan`` chooses the kernel's route for a read and its number of KV
splits, and is the one place that does (the kernel dispatches on what it
is given and refuses a route not built for the inputs): bf16 queries over a bf16 or int8 pool with more than 16 head-packed rows
(prefill chunks, speculative verification) and Dh 64/128 take the
tensor-core route; every other read takes the CUDA-core route, and a read
of at most 16 rows (decode) splits its KV walk so that the grid fills
the card.
``launches`` counts reads that launched the kernel, one per call of
``paged_flash_attention`` whatever number of grid launches the read
issues (a split clipped read issues two), so a forward of L layers
counts L; it counts nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.device import sm_count
from repro_torch.kernels.build import load

NEG_INF = -1e30

# reads that launched the kernel, one per ``paged_flash_attention`` call
# (plain integer)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_lib: Optional[ctypes.CDLL] = None
ROWS_CC = 16         # head-packed query rows per CTA, CUDA-core route
MAX_SPLITS = 16
SPLIT_TILE = 32      # tokens per KV tile of a split read; a split covers whole tiles


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("paged_attention")
        fn = lib.paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_float] * 3
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def plan(q_dtype: torch.dtype, kv_dtype: torch.dtype, b: int, hkv: int, tq_g: int,
         dh: int, width_tokens: int, sms: int) -> tuple:
    """(route, splits) of a read: route "tensor-core" or "cuda-core", and
    the number of chunks each row's KV walk is cut into (1 unless the
    read has at most 16 head-packed rows). Splits aim at 4 CTAs per SM
    of the card's ``sms`` (B * Hkv CTAs per split; at least 2 per SM where
    16 splits allow), at most 16 and at most one per 32-token tile of the
    table's width (``width_tokens`` = W * BS)."""
    tc = (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
          and tq_g > ROWS_CC and dh in (64, 128))
    if tq_g > ROWS_CC:
        return ("tensor-core" if tc else "cuda-core"), 1
    want = -(-4 * sms // (b * hkv))
    return "cuda-core", max(1, min(want, MAX_SPLITS, -(-width_tokens // SPLIT_TILE)))


def paged_flash_attention_ref(
    q: torch.Tensor,            # (B, Hkv, Tq*G, Dh)
    k_pool: torch.Tensor,       # (NB, BS, Hkv, Dh)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, W) int32, -1 = unallocated
    q_off: torch.Tensor,        # (B,) int32
    gate_pi: Optional[torch.Tensor] = None,   # (B, Hkv, Tq*G)
    *,
    group: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    gamma: float = 0.0,
    zeta: float = 1.0,
    k_scale: Optional[torch.Tensor] = None,   # (NB, BS) f32
    v_scale: Optional[torch.Tensor] = None,
    live_widths: Optional[torch.Tensor] = None,  # (B,) int32
) -> torch.Tensor:
    """The plain PyTorch version: gather each row's virtual KV sequence,
    mask, softmax (or clipped softmax) and P·V, all in f32; the output is
    cast to q's dtype."""
    b, hkv, tq_g, dh = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    w = block_table.shape[1]
    tk = w * bs
    dev = q.device
    valid_entry = block_table >= 0
    if live_widths is not None:
        valid_entry &= torch.arange(w, device=dev)[None, :] < live_widths[:, None]
    safe = torch.where(valid_entry, torch.clamp(block_table, 0, nb - 1), 0).long()

    def gather(pool, scale):
        x = pool[safe].reshape(b, tk, hkv, dh).permute(0, 2, 1, 3).float()
        if scale is not None:
            x = x * scale[safe].reshape(b, 1, tk, 1)
        return x                                            # (B, Hkv, Tk, Dh)

    k, v = gather(k_pool, k_scale), gather(v_pool, v_scale)
    s = torch.einsum("bhrd,bhkd->bhrk", q.float(), k) * dh ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / torch.full((), softcap, device=dev))
    q_pos = q_off.to(dev).long()[:, None] + \
        torch.arange(tq_g, device=dev) // group              # (B, R)
    k_pos = torch.arange(tk, device=dev)
    mask = torch.repeat_interleave(valid_entry, bs, dim=1)[:, None, :] \
        .expand(b, tq_g, tk)
    if causal:
        mask = mask & (k_pos <= q_pos[..., None])
    if window is not None:
        mask = mask & (k_pos > q_pos[..., None] - window)
    mask = mask[:, None]                                     # (B, 1, R, Tk)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    z = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    if gamma == 0.0 and zeta == 1.0:
        out = (p @ v) / z
    else:
        p = torch.clamp((zeta - gamma) * (p / z) + gamma, 0.0, 1.0)
        out = torch.where(mask, p, 0.0) @ v
    if gate_pi is not None:
        out = out * gate_pi.float()[..., None]
    return out.to(q.dtype)


def _check(q, k_pool, v_pool, block_table, q_off, gate_pi, k_scale, v_scale,
           live_widths) -> None:
    dev = q.device
    b, hkv, tq_g, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dim() != 4 or k_pool.shape[2:] != (hkv, dh) or \
            v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError("k_pool and v_pool dtypes differ")
    quantized = k_pool.dtype == torch.int8
    # fp pools hold q's dtype, or bf16 under f32 queries (the W8A8 tick's
    # f32 projections over a bf16 pool), computed in f32
    if not quantized and k_pool.dtype != q.dtype and \
            (q.dtype, k_pool.dtype) != (torch.float32, torch.bfloat16):
        raise TypeError(f"fp pools must match q's dtype {q.dtype} (or be "
                        f"bfloat16 under float32 q), got {k_pool.dtype}")
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools need k_scale and v_scale, fp pools none")
    nb, bs = k_pool.shape[:2]
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("block_table", block_table), ("q_off", q_off)]
    if k_scale is not None:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
        for n, t in named[-2:]:
            if t.dtype != torch.float32 or t.shape != (nb, bs):
                raise ValueError(f"{n} must be float32 {(nb, bs)}")
    if block_table.dtype != torch.int32 or block_table.dim() != 2 or \
            block_table.shape[0] != b:
        raise ValueError(f"block_table must be int32 ({b}, W)")
    if q_off.dtype != torch.int32 or q_off.shape != (b,):
        raise ValueError(f"q_off must be int32 ({b},)")
    if live_widths is not None:
        named.append(("live_widths", live_widths))
        if live_widths.dtype != torch.int32 or live_widths.shape != (b,):
            raise ValueError(f"live_widths must be int32 ({b},)")
    if gate_pi is not None:
        named.append(("gate_pi", gate_pi))
        if gate_pi.dtype != torch.float32 or gate_pi.shape != (b, hkv, tq_g):
            raise ValueError(f"gate_pi must be float32 {(b, hkv, tq_g)}")
    for n, t in named:
        if t.device != dev:
            raise ValueError(f"{n} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    if not 1 <= dh <= 256 or (dh * k_pool.element_size()) % 16:
        raise ValueError(f"head dim {dh}: the kernel takes 1..256 with rows of "
                         f"a multiple of 16 bytes")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")


def paged_flash_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_table: torch.Tensor,
    q_off: torch.Tensor,
    gate_pi: Optional[torch.Tensor] = None,
    *,
    group: int = 1,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    gamma: float = 0.0,
    zeta: float = 1.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    live_widths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused paged attention: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. (gamma, zeta) = (0, 1) selects the vanilla
    one-pass path, anything else the two-pass clipped path; ``gamma`` must
    already be resolved from the logical max_len. ``gate_pi`` must be
    float32 for the kernel."""
    kw = dict(group=group, causal=causal, window=window, softcap=softcap,
              gamma=gamma, zeta=zeta, k_scale=k_scale, v_scale=v_scale,
              live_widths=live_widths)
    if q.device.type == "cpu":
        return paged_flash_attention_ref(q, k_pool, v_pool, block_table, q_off,
                                         gate_pi, **kw)
    if not q.is_cuda:
        raise ValueError(f"paged_flash_attention: unsupported device {q.device}")
    _check(q, k_pool, v_pool, block_table, q_off, gate_pi, k_scale, v_scale,
           live_widths)
    b, hkv, tq_g, dh = q.shape
    nb, bs = k_pool.shape[:2]
    w = block_table.shape[1]
    out = torch.empty_like(q)
    route, splits = plan(q.dtype, k_pool.dtype, b, hkv, tq_g, dh, w * bs,
                         sm_count(q.device))
    ws = tickets = None
    if splits > 1:   # one row tile per (b, h): partial (m, Z) and acc per split
        parts = b * hkv
        ws = torch.empty(parts * splits * ROWS_CC * (dh + 2), dtype=torch.float32,
                         device=q.device)
        tickets = torch.zeros(parts, dtype=torch.int32, device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel_lib().paged_attention_launch(
            ptr(q), ptr(k_pool), ptr(v_pool), ptr(k_scale), ptr(v_scale),
            ptr(block_table), ptr(q_off), ptr(live_widths), ptr(gate_pi),
            ptr(out), ptr(ws), ptr(tickets), b, hkv, tq_g, dh, nb, bs, w, group,
            int(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            int(not (gamma == 0.0 and zeta == 1.0)), float(gamma), float(zeta),
            float(dh ** -0.5), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype],
            int(route == "tensor-core"), splits, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out


def paged_mha(
    q: torch.Tensor,            # (B, Tq, Hq, Dh) — model layout
    k_pool: torch.Tensor,       # (NB, BS, Hkv, Dh)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # (B, W)
    q_offset=0,                 # int or per-row (B,) tensor
    gate_pi: Optional[torch.Tensor] = None,   # (B, Tq, Hq)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    gamma: float = 0.0,
    zeta: float = 1.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    live_widths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Model-layout adapter: head-group the queries (all G query heads of a
    KV head share one pool read) and call ``paged_flash_attention``.
    Returns (B, Tq, Hq, Dh) like ``dense_attention``."""
    b, tq, hq, dh = q.shape
    hkv = k_pool.shape[2]
    g = hq // hkv
    qf = q.reshape(b, tq, hkv, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, tq * g, dh).contiguous()
    gf = None
    if gate_pi is not None:
        gf = gate_pi.reshape(b, tq, hkv, g).permute(0, 2, 1, 3) \
            .reshape(b, hkv, tq * g).float().contiguous()
    off = torch.broadcast_to(
        torch.as_tensor(q_offset, dtype=torch.int32, device=q.device), (b,)
    ).contiguous()
    lw = None if live_widths is None else \
        live_widths.to(device=q.device, dtype=torch.int32).contiguous()
    out = paged_flash_attention(
        qf, k_pool, v_pool, block_table.to(torch.int32).contiguous(), off, gf,
        group=g, causal=causal, window=window, softcap=softcap, gamma=gamma,
        zeta=zeta, k_scale=k_scale, v_scale=v_scale, live_widths=lw)
    return out.reshape(b, hkv, tq, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, tq, hq, dh)
