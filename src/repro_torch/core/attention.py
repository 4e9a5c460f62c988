"""Multi-head attention with the paper's modifications, GQA, local
windows and logit soft-capping (port of ``repro.core.attention``).

Read paths:

  * ``dense_attention`` — materializes the (Tq, Tk) probabilities; the
    reference semantics.
  * ``chunked_attention`` — the plain blockwise version over KV chunks,
    O(T) memory: one online (m, Z, acc) pass for the vanilla softmax; for
    the clipped softmax a second pass applies the stretch-and-clip to the
    globally normalized probabilities chunk by chunk.
  * ``attention`` — the dispatcher of every cache-free forward. CUDA
    tensors go to the hand-written flash kernel
    (``repro_torch.kernels.flash_attention``), and under a gradient
    through its autograd Function, whose backward is the hand-written
    backward kernel; CPU tensors route exactly as the reference does, to
    ``dense_attention`` for small problems and ``chunked_attention``
    above tq*tk = 2048^2 (autograd differentiates them, as XLA
    differentiates the reference's).
  * ``paged_attention`` — serving reads over a paged KV cache: K/V live in
    a global block pool ``(num_blocks, block_size, Hkv, Dh)`` and each
    batch row owns a block table of physical ids (-1 = unallocated). It
    dispatches by the tensors' device: CUDA tensors go to the hand-written
    Hopper kernel (``repro_torch.kernels.paged_attention``), CPU tensors
    to ``paged_attention_gather``, the plain PyTorch path that gathers
    each row's virtual KV sequence and masks it. The plain path is the
    CPU path only when the caller put the tensors there; it is never a
    fallback for CUDA tensors (nor are dense and chunked attention).

Layout: q (B, Tq, Hq, Dh); k/v (B, Tk, Hkv, Dh) with Hq = G * Hkv.
Every ``q_offset`` may be a shared python int or a per-row (B,) int32
tensor; with a tensor, masks gain a leading batch dimension and every row
attends at its own absolute position.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.softmax import (
    ClippedSoftmaxConfig,
    softcap,
    softmax,
    stretch_and_clip,
)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    d_head: int
    causal: bool = True
    window: Optional[int] = None            # local attention window (tokens back)
    logit_softcap: Optional[float] = None   # gemma-2 style tanh cap
    softmax: ClippedSoftmaxConfig = ClippedSoftmaxConfig()
    chunk_size: int = 512                   # KV block for the chunked path

    @property
    def group_size(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads


def make_attention_mask(q_len: int, kv_len: int, causal: bool,
                        window: Optional[int] = None, q_offset=0,
                        device=None) -> torch.Tensor:
    """Boolean mask, True = may attend: (q_len, kv_len) for a scalar
    ``q_offset``, (B, q_len, kv_len) for a per-row (B,) tensor."""
    if isinstance(q_offset, torch.Tensor):
        device = q_offset.device
    off = torch.as_tensor(q_offset, dtype=torch.int64, device=device)
    q_pos = (off[..., None] + torch.arange(q_len, device=device))[..., :, None]
    k_pos = torch.arange(kv_len, device=device)
    mask = torch.ones(q_pos.shape[:-1] + (kv_len,), dtype=torch.bool,
                      device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def attention_logits(q: torch.Tensor, k: torch.Tensor, cfg: AttentionConfig
                     ) -> torch.Tensor:
    """(B, Hkv, G, Tq, Tk) scaled and (optionally) soft-capped f32 logits.
    q is scaled in its own dtype before the f32 cast, as the reference."""
    b, tq, hq, d = q.shape
    qg = q.reshape(b, tq, cfg.n_kv_heads, cfg.group_size, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", (qg * d ** -0.5).float(),
                          k.float())
    return softcap(logits, cfg.logit_softcap)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: AttentionConfig, mask: Optional[torch.Tensor] = None,
                    q_offset=0, gate_pi: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Reference attention. Returns (B, Tq, Hq, Dh).

    ``mask``: optional (Tq, Tk) shared or (B, Tq, Tk) per-row boolean.
    ``gate_pi``: optional (B, Tq, Hq) gate probabilities (paper Eq. 5).
    Probabilities are cast to ``v.dtype`` before P·V, as the reference."""
    b, tq, hq, d = q.shape
    tk = k.shape[1]
    logits = attention_logits(q, k, cfg)               # (B, Hkv, G, Tq, Tk)
    if mask is None:
        mask = make_attention_mask(tq, tk, cfg.causal, cfg.window, q_offset,
                                   device=q.device)
    if mask.ndim == 3:                                 # per-row (B, Tq, Tk)
        mask = mask[:, None, None]
    mask_b = torch.broadcast_to(mask, logits.shape)
    sm = cfg.softmax
    probs = softmax(logits, dim=-1, where=mask_b)
    if not sm.is_vanilla:
        # masked entries clip to clip(gamma, 0, 1) = 0 (softmax gave 0 there)
        probs = stretch_and_clip(probs, sm.resolve_gamma(tk), sm.zeta)
    probs = probs.to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, tq, hq, d)
    if gate_pi is not None:
        out = out * gate_pi[..., None].to(out.dtype)
    return out


def _chunk_mask(idx: int, c: int, tk: int, tq: int, q_offset, cfg: AttentionConfig,
                device) -> torch.Tensor:
    """Validity mask of one KV chunk: (Tq, c) for a scalar ``q_offset``,
    (B, Tq, c) for a per-row tensor."""
    off = torch.as_tensor(q_offset, dtype=torch.int64, device=device)
    q_pos = (off[..., None] + torch.arange(tq, device=device))[..., :, None]
    k_pos = idx * c + torch.arange(c, device=device)
    mask = torch.broadcast_to(k_pos < tk, q_pos.shape[:-1] + (c,))
    if cfg.causal:
        mask = mask & (k_pos <= q_pos)
    if cfg.window is not None:
        mask = mask & (k_pos > q_pos - cfg.window)
    return mask


def _lift_mask(mask: torch.Tensor) -> torch.Tensor:
    """Lift a (Tq, c) / (B, Tq, c) mask against (B, Hkv, G, Tq, c) logits."""
    return mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]


def _chunks(q, k, v, cfg: AttentionConfig):
    """q grouped and scaled in its dtype, then f32: (B, Tq, Hkv, G, D);
    and the KV chunks, zero-padded to a whole number of chunks."""
    b, tq, hq, d = q.shape
    c, tk = cfg.chunk_size, k.shape[1]
    n_chunks = (tk + c - 1) // c
    pad = n_chunks * c - tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = (q * d ** -0.5).reshape(b, tq, cfg.n_kv_heads, cfg.group_size, d).float()
    return qg, [(i, k[:, i * c:(i + 1) * c], v[:, i * c:(i + 1) * c])
                for i in range(n_chunks)]


def _online_pass(q, k, v, cfg: AttentionConfig, q_offset
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-pass online softmax over KV chunks. Returns (acc, m, z) with
    acc = sum exp(s - m) v per query: acc (B, Hkv, G, Tq, D); m, z
    (B, Hkv, G, Tq)."""
    b, tq, _, d = q.shape
    g, hkv, c, tk = cfg.group_size, cfg.n_kv_heads, cfg.chunk_size, k.shape[1]
    qg, chunks = _chunks(q, k, v, cfg)
    acc = torch.zeros((b, hkv, g, tq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, g, tq), NEG_INF, dtype=torch.float32, device=q.device)
    z = torch.zeros((b, hkv, g, tq), dtype=torch.float32, device=q.device)
    for idx, kb, vb in chunks:
        s = softcap(torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float()), cfg.logit_softcap)
        mask = _chunk_mask(idx, c, tk, tq, q_offset, cfg, q.device)
        s = torch.where(_lift_mask(mask), s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        z = z * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb.float())
        m = m_new
    return acc, m, z


def _clipped_second_pass(q, k, v, m, z, cfg: AttentionConfig, q_offset) -> torch.Tensor:
    """Pass 2 of the clipped softmax: accumulate clip((zeta-gamma)p + gamma)·V
    chunk by chunk, gamma resolved from the KV length."""
    b, tq, _, d = q.shape
    g, hkv, c, tk = cfg.group_size, cfg.n_kv_heads, cfg.chunk_size, k.shape[1]
    gamma, zeta = cfg.softmax.resolve_gamma(tk), cfg.softmax.zeta
    qg, chunks = _chunks(q, k, v, cfg)
    z_safe = torch.clamp(z, min=torch.finfo(torch.float32).tiny)
    acc = torch.zeros((b, hkv, g, tq, d), dtype=torch.float32, device=q.device)
    for idx, kb, vb in chunks:
        s = softcap(torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float()), cfg.logit_softcap)
        mask = _chunk_mask(idx, c, tk, tq, q_offset, cfg, q.device)
        p = stretch_and_clip(torch.exp(s - m[..., None]) / z_safe[..., None], gamma, zeta)
        p = torch.where(_lift_mask(mask), p, 0.0)
        acc = acc + torch.einsum("bhgqk,bkhd->bhgqd", p, vb.float())
    return acc


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: AttentionConfig, q_offset=0,
                      gate_pi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash-style O(T)-memory attention with the vanilla or the clipped
    softmax, in plain PyTorch. Returns (B, Tq, Hq, Dh) in v's dtype."""
    b, tq, hq, d = q.shape
    acc, m, z = _online_pass(q, k, v, cfg, q_offset)
    if cfg.softmax.is_vanilla:
        out = acc / torch.clamp(z, min=torch.finfo(torch.float32).tiny)[..., None]
    else:
        out = _clipped_second_pass(q, k, v, m, z, cfg, q_offset)
    out = out.movedim(3, 1).reshape(b, tq, hq, d).to(v.dtype)
    if gate_pi is not None:
        out = out * gate_pi[..., None].to(out.dtype)
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: AttentionConfig, q_offset=0,
              gate_pi: Optional[torch.Tensor] = None,
              force_dense: bool = False) -> torch.Tensor:
    """Dispatcher of the cache-free read. Returns (B, Tq, Hq, Dh).

    CUDA tensors: always the flash kernel, with gamma resolved from the
    KV length, as the plain paths do; q, k and v of different dtypes (the
    W8A8 tick's f32 queries over a bf16 dense cache) are promoted to one
    first, as the plain paths promote them before their products. Inputs
    that need a gradient (training) take the kernel's autograd Function:
    its backward is the flash backward kernel, which takes f32 at Dh 32
    and 64 without window, softcap or query offset, and anything else
    raises (``mha_flash``); there is no plain path for CUDA tensors. CPU
    tensors: the reference's routing, dense when forced, when decoding
    (tq == 1) with tk <= 8192, or when tq > 1 and tq*tk <= 2048^2;
    chunked otherwise."""
    tq, tk = q.shape[1], k.shape[1]
    if q.is_cuda:
        from repro_torch.kernels.flash_attention import mha_flash
        dt = torch.promote_types(q.dtype, k.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        sm = cfg.softmax
        gamma, zeta = (0.0, 1.0) if sm.is_vanilla else (sm.resolve_gamma(tk), sm.zeta)
        return mha_flash(q, k, v, gate_pi, causal=cfg.causal, window=cfg.window,
                         softcap=cfg.logit_softcap, gamma=gamma, zeta=zeta,
                         q_offset=q_offset)
    if force_dense or (tq == 1 and tk <= 8192) or (tq > 1 and tq * tk <= 2048 * 2048):
        return dense_attention(q, k, v, cfg, q_offset=q_offset, gate_pi=gate_pi)
    return chunked_attention(q, k, v, cfg, q_offset=q_offset, gate_pi=gate_pi)


def paged_attention_gather(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           cfg: AttentionConfig, q_offset=0,
                           gate_pi: Optional[torch.Tensor] = None,
                           live_widths: Optional[torch.Tensor] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Gather-based attention over a paged KV cache. Returns (B, Tq, Hq, Dh).

    Each row's blocks are gathered into a (B, W*block_size, Hkv, Dh)
    virtual sequence indexed by logical position, so the causal/window
    mask from ``q_offset`` applies unchanged; unallocated entries (id < 0)
    and entries at or past a row's ``live_widths`` count are masked out
    (their gather is redirected to block 0 and zeroed). Int8 pools are
    dequantized by the gathered per-slot ``k_scale``/``v_scale``. If
    ``cfg.softmax`` uses ``alpha``, gamma resolves from W*block_size:
    callers slicing the table must pre-resolve it (``paged_attention``
    does)."""
    b, w = block_table.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    tq, tk = q.shape[1], w * bs
    valid_entry = block_table >= 0                               # (B, W)
    if live_widths is not None:
        valid_entry &= torch.arange(w, device=q.device)[None, :] < \
            live_widths.to(q.device)[:, None]
    safe = torch.where(valid_entry, torch.clamp(block_table, 0, nb - 1), 0).long()
    k = k_pool[safe].reshape(b, tk, *k_pool.shape[2:])
    v = v_pool[safe].reshape(b, tk, *v_pool.shape[2:])
    if k_scale is not None:
        k = k.float() * k_scale[safe].reshape(b, tk)[:, :, None, None]
    if v_scale is not None:
        v = v.float() * v_scale[safe].reshape(b, tk)[:, :, None, None]
    valid = torch.repeat_interleave(valid_entry, bs, dim=1)     # (B, Tk)
    if live_widths is not None:
        # dead lanes are masked out of the softmax below; zeroing the
        # gathered values keeps every dead-lane product an exact zero
        zmask = valid[:, :, None, None]
        k = torch.where(zmask, k, torch.zeros((), dtype=k.dtype, device=k.device))
        v = torch.where(zmask, v, torch.zeros((), dtype=v.dtype, device=v.device))
    mask = make_attention_mask(tq, tk, cfg.causal, cfg.window, q_offset,
                               device=q.device)
    mask = torch.broadcast_to(mask, (b, tq, tk)) & valid[:, None, :]
    return dense_attention(q, k, v, cfg, mask=mask, gate_pi=gate_pi)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_table: torch.Tensor, cfg: AttentionConfig,
                    q_offset=0, gate_pi: Optional[torch.Tensor] = None, *,
                    live_width: Optional[int] = None,
                    live_widths: Optional[torch.Tensor] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    backend: str = "auto") -> torch.Tensor:
    """Paged-KV attention dispatcher. Returns (B, Tq, Hq, Dh).

    ``backend``: ``"auto"`` picks by the tensors' device — the Hopper
    kernel for CUDA tensors, ``paged_attention_gather`` for CPU tensors;
    ``"kernel"`` demands the kernel and raises on CPU tensors;
    ``"gather"`` runs the plain path wherever the tensors are.

    The clipped softmax's ``alpha`` is resolved against the LOGICAL
    length W_full*block_size *before* ``live_width`` slices the table, so
    the clip threshold is invariant to how many blocks are live. The
    kernel honours ``live_widths`` as a per-row early exit; masked
    entries contribute exact zeros, so that is exact."""
    b, w_full = block_table.shape
    bs = k_pool.shape[1]
    sm = cfg.softmax
    if not sm.is_vanilla:
        # pin gamma to the logical max_len: the read paths would otherwise
        # resolve it from the (possibly sliced) KV axis
        gamma, zeta = sm.resolve_gamma(w_full * bs), sm.zeta
        cfg = dataclasses.replace(
            cfg, softmax=ClippedSoftmaxConfig(gamma=gamma, zeta=zeta))
    else:
        gamma, zeta = 0.0, 1.0
    if live_width is not None:
        block_table = block_table[:, :max(1, min(int(live_width), w_full))]
    if backend == "auto":
        backend = "kernel" if q.is_cuda else "gather"
    if backend == "kernel":
        if not q.is_cuda:
            raise ValueError(
                "paged_attention(backend='kernel') needs CUDA tensors; the "
                f"inputs are on {q.device}")
        from repro_torch.kernels.paged_attention import paged_mha
        return paged_mha(q, k_pool, v_pool, block_table.contiguous(), q_offset,
                         gate_pi, causal=cfg.causal, window=cfg.window,
                         softcap=cfg.logit_softcap, gamma=gamma, zeta=zeta,
                         k_scale=k_scale, v_scale=v_scale,
                         live_widths=live_widths)
    if backend != "gather":
        raise ValueError(f"unknown paged-attention backend {backend!r}")
    return paged_attention_gather(q, k_pool, v_pool, block_table, cfg,
                                  q_offset=q_offset, gate_pi=gate_pi,
                                  live_widths=live_widths,
                                  k_scale=k_scale, v_scale=v_scale)
