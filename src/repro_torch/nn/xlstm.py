"""xLSTM blocks (port of ``repro.nn.xlstm``; arXiv:2405.04517): mLSTM
(matrix memory, parallel over a chunk) and sLSTM (scalar memory,
recurrent), with exponential gating and stabilizers.

Plain PyTorch, as the reference is plain XLA (no kernel of its own):

  * ``mlstm_chunkwise``, the chunkwise-parallel mLSTM: an attention-like
    quadratic form inside a chunk, the (C, n, m) state carried from chunk
    to chunk by a python loop (the reference's ``lax.scan``); exact with
    respect to the recurrent definition, ``mlstm_recurrent_ref``;
  * ``slstm_scan``, the sLSTM, one step per token (sequential, like the
    original): every step is a handful of eager kernels.

Stabilized mLSTM recurrence (per head):
    m_t = max(logf_t + m_{t-1}, logi_t)
    C_t = e^{logf_t + m_{t-1} - m_t} C_{t-1} + e^{logi_t - m_t} k_t v_t^T
    n_t = e^{logf_t + m_{t-1} - m_t} n_{t-1} + e^{logi_t - m_t} k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, e^{-m_t}),   q scaled by d_k^-0.5

The mLSTM block runs the recurrent form for one step with a state (a
decode step) and the chunkwise form otherwise, as the reference does, so
served bits follow the same arithmetic in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import conv1d_apply, conv1d_init, linear_apply, linear_init
from repro_torch.nn.module import Params, normal_init, split_keys
from repro_torch.quant.qconfig import NO_QUANT, QuantContext

_M_INIT = -1e30    # the stabilizer's start: no input seen yet


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_ff_factor: float = 4.0 / 3.0
    conv_width: int = 4
    chunk_size: int = 64

    @property
    def d_inner(self) -> int:
        return int(self.mlstm_proj_factor * self.d_model)

    @property
    def dh_inner(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def dh_model(self) -> int:
        return self.d_model // self.n_heads


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x), softplus as logaddexp(x, 0)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


# --------------------------------------------------------------------------
# mLSTM cell
# --------------------------------------------------------------------------
def mlstm_recurrent_ref(q, k, v, logi, logf, state=None):
    """Sequential oracle. q, k, v: (B, T, H, D); logi/logf: (B, T, H).

    Returns (h (B, T, H, D) f32, state = (C (B, H, D, D), n (B, H, D),
    m (B, H)))."""
    b, t, h, d = q.shape
    scale = d ** -0.5
    dev = q.device
    if state is None:
        C = torch.zeros((b, h, d, d), dtype=torch.float32, device=dev)
        n = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
        m = torch.full((b, h), -math.inf, dtype=torch.float32, device=dev)
    else:
        C, n, m = state
    q, k, v, logi, logf = (x.float() for x in (q, k, v, logi, logf))
    hs = []
    for s in range(t):
        qt, kt, vt, li, lf = q[:, s], k[:, s], v[:, s], logi[:, s], logf[:, s]
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = fp[..., None] * n + ip[..., None] * kt
        qs = qt * scale
        num = torch.einsum("bhd,bhde->bhe", qs, C)
        den = torch.abs(torch.einsum("bhd,bhd->bh", qs, n))
        den = torch.maximum(den, torch.exp(-m_new))
        m = m_new
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_chunkwise(q, k, v, logi, logf, chunk: int = 64, state=None):
    """Chunkwise-parallel mLSTM, exact match of the recurrent form.

    q, k, v: (B, T, H, D); logi/logf: (B, T, H). Returns (h (B, T, H, D)
    f32, final state). Steps past T (padding to a whole chunk) carry the
    reference's sentinels: logf = 0 (keep the state), logi = -1e30 (no
    input)."""
    b, t, h, d = q.shape
    scale = d ** -0.5
    L = min(chunk, t)
    n_chunks = (t + L - 1) // L
    pad = n_chunks * L - t
    dev = q.device
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        logi, logf = (F.pad(x, (0, 0, 0, pad)) for x in (logi, logf))
        live = (torch.arange(n_chunks * L, device=dev) < t)[None, :, None]
        logi = torch.where(live, logi, torch.full((), -1e30, dtype=logi.dtype, device=dev))
        logf = torch.where(live, logf, torch.zeros((), dtype=logf.dtype, device=dev))
    q, k, v, logi, logf = (x.float() for x in (q, k, v, logi, logf))
    if state is None:
        C = torch.zeros((b, h, d, d), dtype=torch.float32, device=dev)
        n = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
        m_prev = torch.full((b, h), _M_INIT, dtype=torch.float32, device=dev)
    else:
        C, n, m_prev = state
    idx = torch.arange(L, device=dev)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]      # j <= i
    hs = []
    for c in range(n_chunks):
        sl = slice(c * L, (c + 1) * L)
        qb, kb, vb, li, lf = q[:, sl], k[:, sl], v[:, sl], logi[:, sl], logf[:, sl]
        Fc = torch.cumsum(lf, dim=1)                                # (B, L, H)
        G = li - Fc
        Mi = torch.cummax(G, dim=1).values                          # over j <= i
        m_inter = Fc + m_prev[:, None, :]
        m_i = torch.maximum(Fc + Mi, m_inter)
        # decay matrix D_ij = exp(F_i - F_j + li_j - m_i), j <= i
        expo = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :] \
            - m_i[:, :, None, :]                                    # (B, i, j, H)
        D = torch.where(causal, torch.exp(expo), torch.zeros((), device=dev))
        qs = qb * scale
        S = torch.einsum("bihd,bjhd->bijh", qs, kb) * D
        inter_w = torch.exp(m_inter - m_i)                          # (B, L, H)
        num = torch.einsum("bijh,bjhe->bihe", S, vb) + inter_w[..., None] * torch.einsum(
            "bihd,bhde->bihe", qs, C)
        # q_i . n_i = sum_j D_ij (q_i . k_j) + inter_w (q_i . n_prev): the
        # first term is exactly sum_j S_ij
        den = torch.sum(S, dim=2) + inter_w * torch.einsum("bihd,bhd->bih", qs, n)
        den = torch.maximum(torch.abs(den), torch.exp(-m_i))
        hs.append(num / den[..., None])
        # the state at the chunk's end
        F_tot = Fc[:, -1, :]                                        # (B, H)
        m_end = torch.maximum(F_tot + m_prev, F_tot + Mi[:, -1, :])
        w_prev = torch.exp(F_tot + m_prev - m_end)
        w_j = torch.exp(F_tot[:, None, :] - Fc + li - m_end[:, None, :])   # (B, L, H)
        C = w_prev[:, :, None, None] * C + torch.einsum("bjh,bjhd,bjhe->bhde", w_j, kb, vb)
        n = w_prev[..., None] * n + torch.einsum("bjh,bjhd->bhd", w_j, kb)
        m_prev = m_end
    out = torch.cat(hs, dim=1) if len(hs) > 1 else hs[0]
    return out[:, :t], (C, n, m_prev)


# --------------------------------------------------------------------------
# sLSTM cell (sequential)
# --------------------------------------------------------------------------
def slstm_scan(z_in, i_in, f_in, o_in, r_params, n_heads: int, state=None):
    """Stabilized sLSTM with per-head recurrent connections.

    z/i/f/o_in: (B, T, D) pre-activations from the input path; r_params:
    {"rz", "ri", "rf", "ro"}: (H, dh, dh) block-diagonal recurrences.
    Returns (h (B, T, D) f32, state = (c, n, m, h), each (B, H, dh) f32)."""
    b, t, d = z_in.shape
    dh = d // n_heads
    dev = z_in.device
    if state is None:
        c = torch.zeros((b, n_heads, dh), dtype=torch.float32, device=dev)
        n = torch.zeros((b, n_heads, dh), dtype=torch.float32, device=dev)
        m = torch.full((b, n_heads, dh), _M_INIT, dtype=torch.float32, device=dev)
        h = torch.zeros((b, n_heads, dh), dtype=torch.float32, device=dev)
    else:
        c, n, m, h = state
    r = {name: r_params[name].float() for name in ("rz", "ri", "rf", "ro")}
    heads = [x.reshape(b, t, n_heads, dh).float() for x in (z_in, i_in, f_in, o_in)]
    hs = []
    for s in range(t):
        zt, it, ft, ot = (x[:, s] for x in heads)
        z = torch.tanh(zt + torch.einsum("bhd,hde->bhe", h, r["rz"]))
        i_pre = it + torch.einsum("bhd,hde->bhe", h, r["ri"])
        f_pre = ft + torch.einsum("bhd,hde->bhe", h, r["rf"])
        o = torch.sigmoid(ot + torch.einsum("bhd,hde->bhe", h, r["ro"]))
        logf = _log_sigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(i_pre - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        h = o * c / torch.maximum(n, torch.exp(-m_new))
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(b, t, d), (c, n, m, h)


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
def headwise_rmsnorm_init(n_heads: int, dh: int, dtype=torch.float32, device=None
                          ) -> Params:
    return {"scale": torch.ones((n_heads, dh), dtype=dtype, device=device)}


def headwise_rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (B, T, H, dh), normalized per head (the xLSTM paper's GroupNorm)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def mlstm_block_init(gen: torch.Generator, cfg: XLSTMConfig, dtype=torch.float32) -> Params:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    ks = split_keys(gen, 8)
    return {
        "up": linear_init(ks[0], d, 2 * di, bias=False, dtype=dtype),
        "conv": conv1d_init(ks[1], di, cfg.conv_width, dtype=dtype),
        "q": linear_init(ks[2], di, di, bias=False, dtype=dtype),
        "k": linear_init(ks[3], di, di, bias=False, dtype=dtype),
        "v": linear_init(ks[4], di, di, bias=False, dtype=dtype),
        "ifgate": linear_init(ks[5], di, 2 * h, dtype=dtype),   # logi/logf preacts
        "norm": headwise_rmsnorm_init(h, cfg.dh_inner, dtype, gen.device),
        "down": linear_init(ks[6], di, d, bias=False, dtype=dtype),
    }


def mlstm_block_apply(p: Params, x: torch.Tensor, cfg: XLSTMConfig,
                      state: Optional[dict] = None,
                      ctx: QuantContext = NO_QUANT, name: str = "mlstm"
                      ) -> Tuple[torch.Tensor, dict]:
    """x: (B, T, d_model). state: {"conv": (B, w-1, d_inner), "cell": (C,
    n, m)} or None. Returns (y, new_state)."""
    b, t, _ = x.shape
    h, dh, di = cfg.n_heads, cfg.dh_inner, cfg.d_inner
    up = linear_apply(p["up"], x, ctx, name + "/up")
    u, z = torch.chunk(up, 2, dim=-1)
    conv_state = None if state is None else state["conv"]
    uc, conv_state = conv1d_apply(p["conv"], u, conv_state)
    uc = F.silu(uc)
    q = linear_apply(p["q"], uc, ctx, name + "/q").reshape(b, t, h, dh)
    k = linear_apply(p["k"], uc, ctx, name + "/k").reshape(b, t, h, dh)
    v = linear_apply(p["v"], u, ctx, name + "/v").reshape(b, t, h, dh)
    gates = linear_apply(p["ifgate"], uc, ctx, name + "/ifgate").float()
    logi, f_pre = torch.chunk(gates, 2, dim=-1)                 # (B, T, H)
    logf = _log_sigmoid(f_pre)
    cell = None if state is None else state["cell"]
    if t == 1 and state is not None:
        hs, cell = mlstm_recurrent_ref(q, k, v, logi, logf, cell)
    else:
        hs, cell = mlstm_chunkwise(q, k, v, logi, logf, cfg.chunk_size, cell)
    hs = headwise_rmsnorm(p["norm"], hs.to(x.dtype)).reshape(b, t, di)
    out = ctx.act(name + "/gated", hs * F.silu(z))
    y = linear_apply(p["down"], out, ctx, name + "/down")
    return y, {"conv": conv_state, "cell": cell}


def slstm_block_init(gen: torch.Generator, cfg: XLSTMConfig, dtype=torch.float32) -> Params:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.dh_model
    # rounded up to a multiple of 64, as the reference's
    dff = (int(cfg.slstm_ff_factor * d) + 63) // 64 * 64
    ks = split_keys(gen, 9)

    def r(g):
        return normal_init(g, (h, dh, dh), 0.1 / math.sqrt(dh), dtype)

    return {
        "conv": conv1d_init(ks[0], d, cfg.conv_width, dtype=dtype),
        "zifo": linear_init(ks[1], d, 4 * d, dtype=dtype),
        "rz": r(ks[2]), "ri": r(ks[3]), "rf": r(ks[4]), "ro": r(ks[5]),
        "norm": headwise_rmsnorm_init(h, dh, dtype, gen.device),
        "ff_up": linear_init(ks[6], d, dff, bias=False, dtype=dtype),
        "ff_gate": linear_init(ks[7], d, dff, bias=False, dtype=dtype),
        "ff_down": linear_init(ks[8], dff, d, bias=False, dtype=dtype),
    }


def slstm_block_apply(p: Params, x: torch.Tensor, cfg: XLSTMConfig,
                      state: Optional[dict] = None,
                      ctx: QuantContext = NO_QUANT, name: str = "slstm"
                      ) -> Tuple[torch.Tensor, dict]:
    """x: (B, T, d_model). state: {"conv": (B, w-1, d_model), "cell": (c,
    n, m, h)} or None. The feed-forward's GeLU is the tanh approximation
    (``jax.nn.gelu``'s default)."""
    b, t, d = x.shape
    conv_state = None if state is None else state["conv"]
    xc, conv_state = conv1d_apply(p["conv"], x, conv_state)
    xc = F.silu(xc)
    zifo = linear_apply(p["zifo"], xc, ctx, name + "/zifo")
    z_in, i_in, f_in, o_in = torch.chunk(zifo, 4, dim=-1)
    cell = None if state is None else state["cell"]
    hs, cell = slstm_scan(z_in, i_in, f_in, o_in,
                          {k: p[k] for k in ("rz", "ri", "rf", "ro")}, cfg.n_heads, cell)
    hs = headwise_rmsnorm(
        p["norm"], hs.reshape(b, t, cfg.n_heads, cfg.dh_model).to(x.dtype)).reshape(b, t, d)
    g = F.gelu(linear_apply(p["ff_gate"], hs, ctx, name + "/ff_gate"), approximate="tanh")
    u = linear_apply(p["ff_up"], hs, ctx, name + "/ff_up")
    y = linear_apply(p["ff_down"], ctx.act(name + "/ff_act", g * u), ctx, name + "/ff_down")
    return y, {"conv": conv_state, "cell": cell}


def xlstm_init_state(batch: int, kind: str, cfg: XLSTMConfig, dtype=torch.float32,
                     device=None) -> dict:
    """A fresh decode state: the conv history in ``dtype``, the cell in f32
    with the stabilizer m at -1e30 (mLSTM: (C, n, m); sLSTM: (c, n, m, h))."""
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "mlstm":
        h, dh = cfg.n_heads, cfg.dh_inner
        return {
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner), dtype=dtype,
                                device=device),
            "cell": (torch.zeros((batch, h, dh, dh), **f32),
                     torch.zeros((batch, h, dh), **f32),
                     torch.full((batch, h), _M_INIT, **f32)),
        }
    h, dh = cfg.n_heads, cfg.dh_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_model), dtype=dtype,
                            device=device),
        "cell": (torch.zeros((batch, h, dh), **f32),
                 torch.zeros((batch, h, dh), **f32),
                 torch.full((batch, h, dh), _M_INIT, **f32),
                 torch.zeros((batch, h, dh), **f32)),
    }
