"""Dense flash attention on Hopper: the wrapper of the hand-written CUDA
kernel ``csrc/flash_attention.cu``, its model-layout adapter and its
plain PyTorch version.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py :
flash_attention`` (adapter ``repro/kernels/ops.py : mha_flash``, oracle
``repro/kernels/ref.py : attention_ref``). Same semantics: causal and
window masks with a query offset, logit softcap, the vanilla softmax in
one online pass, the clipped softmax ``clip((zeta-gamma)*p+gamma, 0, 1)``
in two passes, the gate multiplying the output; scores, softmax and
products accumulate in f32 (bf16 inputs on the kernel's tensor-core
route: products of bf16 data are exact, and P is carried at f32
precision as two bf16 operands) and the output has q's dtype. (gamma, zeta) = (0, 1) selects the
vanilla path; ``gamma`` arrives resolved. q is multiplied by Dh^-0.5 in
its own dtype before the products, as the model's attention paths
(``dense_attention``, ``chunked_attention``) scale it; the TPU kernel
scales the f32 scores instead, which differs by an ulp in f32 and by
that rounding of q in bf16.

``flash_attention`` (TPU layout (BH, T, Dh)) and ``mha_flash`` (model
layout (B, T, H, Dh) with GQA) launch the kernel for CUDA tensors, and
raise if they cannot, and compute the plain version for CPU tensors —
only because the tensors lie on the CPU. On the card ``mha_flash`` never
repeats K/V: the kernel reads KV head h // G for query head h.
``attention_ref`` (and ``mha_flash_ref`` over the model layout) is the
plain version, used by the CPU tests and by ``chip_smoke.py`` to hold the
kernel on the card. ``launches`` counts kernel launches, and nothing else.

The gradient: ``FlashAttention`` (a ``torch.autograd.Function``) runs the
forward kernel asking it for what the backward reads (``_launch_saved``:
each row's (m, max(Z, 1e-30)) and, under a gate, the ungated output u
beside out; without a gate u is out itself) and keeps those beside q, k,
v and the gate; its backward is the hand-written kernel
``csrc/flash_attention_bwd.cu`` (wrapper ``_launch_bwd``; its launches in
``bwd_launches``, one per call), which recomputes S but nothing else of
the forward. On CUDA, ``mha_flash`` and ``flash_attention`` send inputs
that need a gradient through it. The backward kernel takes f32 at Dh 32
and 64, causal or not, GQA, vanilla, clipped and gated, without window,
softcap or query offset; for anything else the wrappers raise under a
gradient (ROADMAP 1.3: the backward's missing routes); nothing switches
to the plain version. On CPU tensors ``FlashAttention`` runs the same
algorithm plainly: the forward ``mha_flash_ref`` with the row statistics
of ``attention_stats_ref``, and backward ``attention_bwd_saved_ref``.
``attention_bwd_ref`` is the gradient written out as formulas from q, k,
v alone, in f32, materializing (Tq, Tk): the yardstick ``chip_smoke.py``
holds the kernel against. (The reference has no such kernel: it trains
through its plain attention and lets XLA differentiate it.)
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import load

NEG_INF = -1e30

# kernel launches made by ``mha_flash`` / ``flash_attention`` (plain integer)
launches = 0
# backward-kernel calls made by ``FlashAttention.backward`` on the card
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
_BWD_HEAD_DIMS = (32, 64)
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int] + [ctypes.c_float] * 3
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_kernel_lib() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = load("flash_attention_bwd")
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel's route for q/k/v of ``dtype`` and head dim ``dh``, fixed
    by the two alone: "tensor-core" (bf16 at Dh 32, 64, 80, 96 or 128:
    wgmma products over a TMA-fed K/V ring, P carried as a hi/lo pair of
    bf16 operands; Dh 80 and 96 run the Dh-128 body over TMA boxes
    zero-filled past Dh) or "cuda-core" (f32, whose tolerance rules out
    bf16 products, and bf16 at Dh 256)."""
    tc = dtype == torch.bfloat16 and dh in (32, 64, 80, 96, 128)
    return "tensor-core" if tc else "cuda-core"


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  gate_pi: Optional[torch.Tensor] = None, *, causal: bool = True,
                  window: Optional[int] = None, softcap: Optional[float] = None,
                  gamma: float = 0.0, zeta: float = 1.0, q_offset=0) -> torch.Tensor:
    """The plain version: (BH, Tq, Dh) x (BH, Tk, Dh) -> (BH, Tq, Dh),
    materializing the (Tq, Tk) scores in f32. ``q_offset`` is an int or a
    per-row (BH,) tensor."""
    bh, tq, dh = q.shape
    tk = k.shape[1]
    dev = q.device
    s = torch.einsum("bqd,bkd->bqk", (q * dh ** -0.5).float(), k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / torch.full((), softcap, device=dev))
    off = torch.as_tensor(q_offset, dtype=torch.int64, device=dev)
    q_pos = off.reshape(-1, 1, 1) + torch.arange(tq, device=dev)[:, None]
    k_pos = torch.arange(tk, device=dev)[None, :]
    mask = torch.ones_like(q_pos >= k_pos)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    if not (gamma == 0.0 and zeta == 1.0):
        p = torch.clamp((zeta - gamma) * p + gamma, 0.0, 1.0)
        p = torch.where(mask, p, 0.0)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    if gate_pi is not None:
        out = out * gate_pi.float()[..., None]
    return out.to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      gate_pi: Optional[torch.Tensor], dout: torch.Tensor, *,
                      causal: bool = True, gamma: float = 0.0, zeta: float = 1.0):
    """The plain backward of ``mha_flash`` (no window, softcap or query
    offset), as formulas in f32, materializing (Tq, Tk): q (B, Tq, Hq, Dh),
    k/v (B, Tk, Hkv, Dh), gate (B, Tq, Hq) or None, dout like q. Returns
    (dq, dk, dv, dgate) in the inputs' dtypes (dgate None without a gate).

    With s = (q Dh^-0.5) k^T (q scaled in its dtype, as the forward), p the
    masked softmax, P~ = p or, clipped, clip((zeta - gamma) p + gamma, 0,
    1) masked, u = P~ v and g = gate dO: dgate = dO . u; dv = P~^T g;
    dP~ = g v^T; dp = dP~, or (zeta - gamma) 1[unclipped] dP~; ds = p (dp -
    D) with D = rowsum(p dp); dq = Dh^-0.5 ds k; dk = ds^T (q Dh^-0.5).
    GQA sums dk and dv over each KV head's query heads."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    qs = (q * scale).float().reshape(b, tq, hkv, g, dh)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, kf)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(tk, device=q.device)[None, :] <= \
            torch.arange(tq, device=q.device)[:, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    do = dout.float().reshape(b, tq, hkv, g, dh)
    gd = do if gate_pi is None else \
        gate_pi.float().reshape(b, tq, hkv, g)[..., None] * do
    dpt = torch.einsum("bqhgd,bkhd->bhgqk", gd, vf)
    if gamma == 0.0 and zeta == 1.0:
        pt, dp = p, dpt
    else:
        x = (zeta - gamma) * p + gamma
        pt = torch.where(mask, torch.clamp(x, 0.0, 1.0), 0.0)
        dp = torch.where(mask & (x > 0) & (x < 1), (zeta - gamma) * dpt, 0.0)
    dsum = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - dsum)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pt, gd)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dgate = None
    if gate_pi is not None:
        u = torch.einsum("bhgqk,bkhd->bqhgd", pt, vf)
        dgate = (do * u).sum(-1).reshape(b, tq, hq).to(gate_pi.dtype)
    return (dq.reshape(b, tq, hq, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dgate)


def _scores(q, k, causal):
    """(B, Hkv, G, Tq, Tk) f32 scores (q Dh^-0.5 rounded in q's dtype, as
    the forward) with hidden entries at NEG_INF, and the (Tq, Tk) mask."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qs = (q * dh ** -0.5).float().reshape(b, tq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, k.float())
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(tk, device=q.device)[None, :] <= \
            torch.arange(tq, device=q.device)[:, None]
    return torch.where(mask, s, NEG_INF), mask


def attention_stats_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True
                        ) -> torch.Tensor:
    """The plain version of the row statistics the forward kernel saves for
    the backward: (2, B, Hq, Tq) f32, m = the row's largest visible score
    and max(Z, 1e-30), Z = sum over visible keys of exp(s - m); q (B, Tq,
    Hq, Dh), k (B, Tk, Hkv, Dh), no window, softcap or query offset."""
    b, tq, hq, _ = q.shape
    s, mask = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    z = torch.where(mask, torch.exp(s - m), 0.0).sum(-1)
    return torch.stack([m[..., 0], torch.clamp(z, min=1e-30)]).reshape(2, b, hq, tq)


def attention_bwd_saved_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            gate_pi: Optional[torch.Tensor], u: torch.Tensor,
                            dout: torch.Tensor, stats: torch.Tensor, *, causal: bool = True,
                            gamma: float = 0.0, zeta: float = 1.0):
    """The backward kernel's algorithm, plainly, in f32, materializing (Tq,
    Tk): from the forward's row statistics ``stats`` ((2, B, Hq, Tq): m,
    max(Z, 1e-30)) and its ungated output ``u`` (B, Tq, Hq, Dh) (out itself
    without a gate) beside q, k, v, gate and dout as ``attention_bwd_ref``.
    p = exp(s - m) / Z from the saved (m, Z); D = rowsum(p dp) is gate (dO
    . u) (vanilla, gated), or, clipped, the sum over S and dP~ = g v^T, and
    then dq = Dh^-0.5 (A - D B) with A = (p dp) k and B = p k, as the
    kernel sums them in one walk; dgate = dO . u. Returns (dq, dk, dv,
    dgate) as ``attention_bwd_ref``."""
    b, tq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    s, mask = _scores(q, k, causal)
    st = stats.float().reshape(2, b, hkv, g, tq)[..., None]
    p = torch.where(mask, torch.exp(s - st[0]) / st[1], 0.0)
    do = dout.float().reshape(b, tq, hkv, g, dh)
    gd = do if gate_pi is None else \
        gate_pi.float().reshape(b, tq, hkv, g)[..., None] * do
    dpt = torch.einsum("bqhgd,bkhd->bhgqk", gd, v.float())
    du = (do * u.float().reshape(b, tq, hkv, g, dh)).sum(-1)       # dO . u
    if gamma == 0.0 and zeta == 1.0:
        pt, dp = p, dpt
        gt = 1.0 if gate_pi is None else gate_pi.float().reshape(b, tq, hkv, g)
        dsum = (gt * du).permute(0, 2, 3, 1)[..., None]
    else:
        x = (zeta - gamma) * p + gamma
        pt = torch.where(mask, torch.clamp(x, 0.0, 1.0), 0.0)
        dp = torch.where(mask & (x > 0) & (x < 1), (zeta - gamma) * dpt, 0.0)
        dsum = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - dsum)
    qs = (q * scale).float().reshape(b, tq, hkv, g, dh)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pt, gd)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
    if gamma == 0.0 and zeta == 1.0:
        dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    else:
        a_ = torch.einsum("bhgqk,bkhd->bqhgd", p * dp, k.float())
        b_ = torch.einsum("bhgqk,bkhd->bqhgd", p, k.float())
        dq = (a_ - dsum[..., 0].permute(0, 3, 1, 2)[..., None] * b_) * scale
    dgate = None if gate_pi is None else du.reshape(b, tq, hq).to(gate_pi.dtype)
    return (dq.reshape(b, tq, hq, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dgate)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _check_bwd(q, k, window, softcap, q_offset) -> None:
    """Raise for what the backward kernel does not take (ROADMAP 1.3)."""
    why = []
    if q.dtype != torch.float32 or k.dtype != torch.float32:
        why.append(f"dtype {q.dtype}")
    if q.shape[-1] not in _BWD_HEAD_DIMS:
        why.append(f"head dim {q.shape[-1]}")
    if window is not None:
        why.append("a window")
    if softcap is not None:
        why.append("a softcap")
    if isinstance(q_offset, torch.Tensor) or q_offset != 0:
        why.append("a query offset")
    if why:
        raise NotImplementedError(
            f"the flash-attention backward kernel takes f32 at Dh {_BWD_HEAD_DIMS} "
            f"without window, softcap or query offset, not {', '.join(why)} "
            f"(ROADMAP 1.3: the backward's missing routes)")


def _launch_saved(q, k, v, gate_pi, causal, gamma, zeta):
    """The forward kernel (f32, CUDA-core route) writing what the backward
    reads: returns (out, u, stats), stats the (2, B, Hq, Tq) rows' (m,
    max(Z, 1e-30)), u the ungated output (out itself without a gate)."""
    if q.dtype != torch.float32:
        raise TypeError("the forward writes row statistics for float32 inputs only")
    b, tq, hq, dh = q.shape
    stats = torch.empty((2, b, hq, tq), dtype=torch.float32, device=q.device)
    u = None if gate_pi is None else torch.empty((b, tq, hq, dh), dtype=torch.float32,
                                                 device=q.device)
    out = _launch(q, k, v, gate_pi, 0, causal=causal, window=None, softcap=None, gamma=gamma,
                  zeta=zeta, stats=stats, u=u)
    return out, (out if u is None else u), stats


def _launch_bwd(q, k, v, gate_pi, u, dout, stats, causal, gamma, zeta):
    """Launch the backward kernel over model-layout f32 tensors (q, k, v
    views with the forward's stride rules; u and stats from
    ``_launch_saved``); returns (dq, dk, dv, dgate) as new contiguous
    tensors (dgate None without a gate)."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if any(t.dtype != torch.float32 for t in (q, k, v, u, dout, stats)):
        raise TypeError("the backward kernel takes float32 q, k, v, u, dout and stats")
    if dh not in _BWD_HEAD_DIMS or k.shape != (b, tk, hkv, dh) or v.shape != k.shape \
            or hq % hkv or dout.shape != q.shape or u.shape != q.shape \
            or stats.shape != (2, b, hq, tq):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"u {tuple(u.shape)}, dout {tuple(dout.shape)}, stats "
                         f"{tuple(stats.shape)}: (B, T, H, Dh) with Dh in {_BWD_HEAD_DIMS}, "
                         f"H_q a multiple of H_kv, stats (2, B, H_q, T_q)")
    dout, u, stats = dout.contiguous(), u.contiguous(), stats.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("u", u), ("dout", dout), ("stats", stats)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name != "stats" and (t.stride(-1) != 1 or any(st % 4 for st in t.stride()[:-1])
                                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a unit last stride and 16-byte aligned rows")
    g = None
    if gate_pi is not None:
        if gate_pi.shape != (b, tq, hq):
            raise ValueError(f"gate_pi must be {(b, tq, hq)}, got {tuple(gate_pi.shape)}")
        g = gate_pi.to(device=q.device, dtype=torch.float32)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((b, tq, hq, dh), **f32)
    dk = torch.empty((b, tk, hkv, dh), **f32)
    dv = torch.empty((b, tk, hkv, dh), **f32)
    dg = None if g is None else torch.empty((b, tq, hq), **f32)
    # scratch: D of every row; gate dO under a gate; per-query-head dk, dv
    # partials under GQA
    dsum = torch.empty((b, hq, tq), **f32)
    gbuf = None if g is None else torch.empty((b, tq, hq, dh), **f32)
    parts = [None, None] if hq == hkv else [torch.empty((b, tk, hq, dh), **f32)
                                            for _ in range(2)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    gs = g.stride() if g is not None else (0, 0, 0)
    clipped = not (gamma == 0.0 and zeta == 1.0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel_lib().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(g), u.data_ptr(), dout.data_ptr(),
            stats.data_ptr(), dsum.data_ptr(), ptr(gbuf), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ptr(dg), ptr(parts[0]), ptr(parts[1]),
            b, tq, tk, hq, hkv, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *gs,
            int(causal), int(clipped), float(zeta - gamma), float(gamma), float(dh ** -0.5),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {err}")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv, dg


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient, over the model layout. Forward:
    on CUDA tensors the forward kernel with the row statistics and u
    (``_launch_saved``; out is bitwise the call ``mha_flash`` makes without
    a gradient), on CPU ones ``mha_flash_ref`` with ``attention_stats_ref``
    (and, under a gate, ``mha_flash_ref`` without it for u). It keeps q, k,
    v, the gate, u (out itself without a gate: the tensor the o-projection
    keeps alive anyway; under a gate one more (B, Tq, Hq, Dh) buffer) and
    the statistics. Backward: ``_launch_bwd`` on CUDA tensors,
    ``attention_bwd_saved_ref`` on CPU ones; dout is made contiguous
    first. Raises for what the backward kernel does not take
    (``_check_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, gate_pi, causal, window, softcap, gamma, zeta, q_offset):
        _check_bwd(q, k, window, softcap, q_offset)
        kw = dict(causal=causal, gamma=gamma, zeta=zeta)
        if q.is_cuda:
            out, u, stats = _launch_saved(q, k, v, gate_pi, **kw)
        else:
            out = mha_flash_ref(q, k, v, gate_pi, **kw)
            u = out if gate_pi is None else mha_flash_ref(q, k, v, None, **kw)
            stats = attention_stats_ref(q, k, causal=causal)
        ctx.save_for_backward(q, k, v, gate_pi, u, stats)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, gate_pi, u, stats = ctx.saved_tensors
        dout = dout.contiguous()
        if q.is_cuda:
            dq, dk, dv, dg = _launch_bwd(q, k, v, gate_pi, u, dout, stats, **ctx.kw)
        else:
            dq, dk, dv, dg = attention_bwd_saved_ref(q, k, v, gate_pi, u, dout, stats,
                                                     **ctx.kw)
        if dg is not None:
            dg = dg.to(gate_pi.dtype)
        return dq, dk, dv, dg, None, None, None, None, None, None


def _launch(q, k, v, gate_pi, q_offset, causal, window, softcap, gamma, zeta, stats=None,
            u=None):
    """Launch the kernel over model-layout (B, T, H, Dh) tensors (views of
    any strides with a unit last stride); returns a new (B, Tq, Hq, Dh).
    ``stats`` ((2, B, Hq, Tq) f32) and ``u`` ((B, Tq, Hq, Dh) f32, under a
    gate), contiguous, receive what the backward reads (f32 only)."""
    if _needs_grad(q, k, v, gate_pi):
        raise RuntimeError("_launch records no gradient: inputs that need one go "
                           "through mha_flash / FlashAttention")
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (b, tk, hkv, dh) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not fit (B, T, H, Dh) with H_q a multiple of H_kv")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh}: the kernel takes {_HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]) or \
                t.data_ptr() % 16:
            raise ValueError(f"{name} needs a unit last stride and 16-byte aligned rows")
    offs = None
    if isinstance(q_offset, torch.Tensor):
        offs = q_offset.to(device=q.device, dtype=torch.int32).reshape(-1)
        offs = torch.broadcast_to(offs, (b,)).contiguous()
        q_offset = 0
    g = None
    if gate_pi is not None:
        if gate_pi.shape != (b, tq, hq):
            raise ValueError(f"gate_pi must be {(b, tq, hq)}, got {tuple(gate_pi.shape)}")
        g = gate_pi.to(device=q.device, dtype=torch.float32)
    out = torch.empty((b, tq, hq, dh), dtype=q.dtype, device=q.device)
    gs = g.stride() if g is not None else (0, 0, 0)
    clipped = not (gamma == 0.0 and zeta == 1.0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel_lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if g is None else g.data_ptr(),
            None if offs is None else offs.data_ptr(), out.data_ptr(),
            b, tq, tk, hq, hkv, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *gs, int(q_offset), int(causal),
            -1 if window is None else int(window), 0.0 if softcap is None else float(softcap),
            int(clipped), float(zeta - gamma), float(gamma), float(dh ** -0.5),
            None if stats is None else stats.data_ptr(), None if u is None else u.data_ptr(),
            _DTYPE_CODE[q.dtype], int(route(q.dtype, dh) == "tensor-core"), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    gate_pi: Optional[torch.Tensor] = None, *, causal: bool = True,
                    window: Optional[int] = None, softcap: Optional[float] = None,
                    gamma: float = 0.0, zeta: float = 1.0, q_offset: int = 0
                    ) -> torch.Tensor:
    """Fused attention over the TPU kernel's layout: q (BH, Tq, Dh), k/v
    (BH, Tk, Dh), gate (BH, Tq). The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    kw = dict(causal=causal, window=window, softcap=softcap, gamma=gamma,
              zeta=zeta, q_offset=q_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, gate_pi, **kw)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = mha_flash(q[:, :, None], k[:, :, None], v[:, :, None],
                    None if gate_pi is None else gate_pi[:, :, None], **kw)
    return out[:, :, 0]


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              gate_pi: Optional[torch.Tensor] = None, *, causal: bool = True,
              window: Optional[int] = None, softcap: Optional[float] = None,
              gamma: float = 0.0, zeta: float = 1.0, q_offset=0) -> torch.Tensor:
    """Model-layout adapter: q (B, T, Hq, Dh), k/v (B, S, Hkv, Dh), gate
    (B, T, Hq); ``q_offset`` an int or a per-row (B,) tensor. Returns
    (B, T, Hq, Dh). On the card the kernel indexes KV heads itself, and
    inputs that need a gradient go through ``FlashAttention`` (the
    backward kernel); on the CPU the plain version ``mha_flash_ref`` runs."""
    kw = dict(causal=causal, window=window, softcap=softcap, gamma=gamma, zeta=zeta,
              q_offset=q_offset)
    if q.is_cuda:
        if _needs_grad(q, k, v, gate_pi):
            return FlashAttention.apply(q, k, v, gate_pi, causal, window, softcap, gamma,
                                        zeta, q_offset)
        return _launch(q, k, v, gate_pi, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"mha_flash: unsupported device {q.device}")
    return mha_flash_ref(q, k, v, gate_pi, **kw)


def mha_flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  gate_pi: Optional[torch.Tensor] = None, *, causal: bool = True,
                  window: Optional[int] = None, softcap: Optional[float] = None,
                  gamma: float = 0.0, zeta: float = 1.0, q_offset=0) -> torch.Tensor:
    """The plain version of ``mha_flash`` on any device: K/V repeated per
    query head and ``attention_ref`` over the flattened (B*H, T, Dh)
    layout, as the reference adapter does."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, t, d)
    kf = k.transpose(1, 2).reshape(b * h, s, d)
    vf = v.transpose(1, 2).reshape(b * h, s, d)
    gf = None if gate_pi is None else gate_pi.transpose(1, 2).reshape(b * h, t)
    if isinstance(q_offset, torch.Tensor):
        q_offset = torch.broadcast_to(q_offset.reshape(-1), (b,)).repeat_interleave(h)
    out = attention_ref(qf, kf, vf, gf, causal=causal, window=window, softcap=softcap,
                        gamma=gamma, zeta=zeta, q_offset=q_offset)
    return out.reshape(b, h, t, d).transpose(1, 2)
