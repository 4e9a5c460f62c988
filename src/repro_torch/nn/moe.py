"""Mixture-of-Experts feed-forward (port of ``repro.nn.moe``; granite-moe,
qwen2-moe).

Router: an f32 linear -> softmax -> top-k, probabilities renormalized over
the selected experts. Optional shared experts (qwen2-moe: 4 shared + 60
routed) are always-on SwiGLU branches added to the routed output.

Two execution paths, as in the reference:

  * ``dense``    — every expert computes every token, combined with the
    (sparse) routing weights. Exact, the oracle of the tests and the
    smoke configs' path.
  * ``dispatch`` — capacity-based dispatch: tokens are grouped
    (``group_size``, the last group zero-padded), each (token, slot)
    claims a position in its expert's capacity-``cap`` buffer in
    slot-major order (every token's first choice before any second
    choice), claims past ``cap`` are dropped (the residual passes the
    token through), and the experts run as batched products over the
    (n_groups * E, cap, D) buffers; a weighted gather combines.

Every group runs in one batched computation with the reference's
semantics. Under a mesh (``distributed.sharding.use_mesh``, DTensor
inputs) the group axis is constrained as the reference's is: over the
data axes, or over the whole mesh when the number of groups divides it
(then the expert weights are gathered whole); without one the
constraints do nothing.

Top-k keeps ``jax.lax.top_k``'s tie rule (equal probabilities: the lower
expert index first, in index order): the order of the k choices decides
which claims drop. ``active`` masks dead tokens (inactive serving rows,
padding tails) out of the combine and out of the capacity accounting.
Aux losses (load balance, router z-loss) are computed over every token,
dead ones included, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import active_mesh, axis_sizes, maybe_constrain
from repro_torch.nn.layers import linear_init
from repro_torch.nn.mlp import mlp_apply, mlp_init
from repro_torch.nn.module import Params, normal_init, split_keys
from repro_torch.quant.qconfig import NO_QUANT, QuantContext


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    n_shared_experts: int = 0      # qwen2-moe shared experts
    shared_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    group_size: int = 4096         # tokens per dispatch group
    mlp_kind: str = "swiglu"
    exec_mode: str = "dispatch"    # "dense" | "dispatch"

    @property
    def shared_ff(self) -> int:
        if self.shared_d_ff is not None:
            return self.shared_d_ff
        return self.d_ff * self.n_shared_experts


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32) -> Params:
    """The router in f32 whatever ``dtype`` (the reference's), the stacked
    experts ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D) in
    ``dtype``, and the shared experts' MLP."""
    gr, ge, gs = split_keys(gen, 3)
    e, f = cfg.n_experts, cfg.d_ff
    g1, g2, g3 = split_keys(ge, 3)
    p: Params = {
        "router": linear_init(gr, d_model, e, bias=False, dtype=torch.float32),
        "w_gate": normal_init(g1, (e, d_model, f), 1.0 / d_model ** 0.5, dtype),
        "w_up": normal_init(g2, (e, d_model, f), 1.0 / d_model ** 0.5, dtype),
        "w_down": normal_init(g3, (e, f, d_model), 1.0 / f ** 0.5, dtype),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = mlp_init(gs, d_model, cfg.shared_ff, cfg.mlp_kind, dtype)
    return p


def top_k_lowest_index(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest values, descending, equal values
    in index order (``torch.topk`` breaks ties in no stated order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p: Params, x2d: torch.Tensor, cfg: MoEConfig,
            top_i: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (top-k probs (N, k) f32, top-k idx (N, k), aux losses).
    ``top_i`` (N, k), when given, stands in for the top-k choice: the
    tokens go to those experts, weighted by their renormalized
    probabilities (for checks that hold two forwards to one routing)."""
    logits = x2d.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    if top_i is None:
        top_p, top_i = top_k_lowest_index(probs, cfg.top_k)
    else:
        top_p = probs.gather(-1, top_i)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch load-balance loss + z-loss
    me = probs.mean(dim=0)                                           # (E,)
    ce = F.one_hot(top_i, cfg.n_experts).sum(dim=1).float().mean(dim=0)  # (E,)
    aux = {"load_balance": cfg.n_experts * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return top_p, top_i, aux


def _experts(p: Params, xb: torch.Tensor) -> torch.Tensor:
    """Every expert on its buffers: xb (G, E, C, D) -> (G, E, C, D)."""
    dt = xb.dtype
    g = torch.einsum("gecd,edf->gecf", xb, p["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", xb, p["w_up"].to(dt))
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, p["w_down"].to(dt))


def _moe_dense(p: Params, x2d: torch.Tensor, top_p: torch.Tensor, top_i: torch.Tensor,
               cfg: MoEConfig) -> torch.Tensor:
    """Reference: all experts on all tokens, sparse combine."""
    dt = x2d.dtype
    g = torch.einsum("nd,edf->nef", x2d, p["w_gate"].to(dt))
    u = torch.einsum("nd,edf->nef", x2d, p["w_up"].to(dt))
    y_all = torch.einsum("nef,efd->ned", F.silu(g) * u, p["w_down"].to(dt))  # (N, E, D)
    combine = (F.one_hot(top_i, cfg.n_experts).to(dt) * top_p[..., None].to(dt)).sum(dim=1)
    return torch.einsum("ned,ne->nd", y_all, combine)


def dispatch_capacity(cfg: MoEConfig, n: int) -> Tuple[int, int, int]:
    """(group size, number of groups, capacity per expert and group) for
    ``n`` tokens: the reference's ``cap``, at least 4, rounded up to a
    multiple of 8."""
    gsz = min(cfg.group_size, n)
    cap = max(int(cfg.capacity_factor * cfg.top_k * gsz / cfg.n_experts), 4)
    return gsz, (n + gsz - 1) // gsz, (cap + 7) // 8 * 8


def _claims(top_i: torch.Tensor, token_mask: torch.Tensor, cfg: MoEConfig, n: int
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The dispatch's claims, slot-major within each group: (flat buffer
    index (G, k * gsz), kept (G, k * gsz) bool, cap). Claim j of a group
    is (slot j // gsz, token j % gsz); its position in its expert's buffer
    counts the live claims on that expert before it (a cumulative sum
    over the one-hot), and a dead claim or one at or past ``cap`` is not
    kept (its index points past the buffers)."""
    e, k = cfg.n_experts, cfg.top_k
    gsz, n_groups, cap = dispatch_capacity(cfg, n)
    pad = n_groups * gsz - n
    if pad:
        # padded tokens keep valid indices and never claim
        top_i = F.pad(top_i, (0, 0, 0, pad))
        token_mask = F.pad(token_mask, (0, pad))
    flat_e = top_i.reshape(n_groups, gsz, k).transpose(1, 2).reshape(n_groups, k * gsz)
    live = token_mask.reshape(n_groups, 1, gsz).expand(n_groups, k, gsz).reshape(
        n_groups, k * gsz)
    onehot = F.one_hot(flat_e, e).to(torch.int32) * live[..., None]
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(dim=-1)
    kept = live & (pos < cap)
    return torch.where(kept, flat_e * cap + pos, e * cap), kept, cap


def _group_axes(n_groups: int) -> tuple:
    """The logical axes of the dispatch's group axis: the whole mesh when
    the number of groups divides it, else the data axes."""
    mesh = active_mesh()
    if mesh is not None:
        total = 1
        for n in axis_sizes(mesh).values():
            total *= n
        if total > 1 and n_groups % total == 0:
            return ("dp", "tp")
    return ("dp",)


def _moe_dispatch(p: Params, x2d: torch.Tensor, top_p: torch.Tensor, top_i: torch.Tensor,
                  cfg: MoEConfig, token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Capacity-based dispatch by scatter and gather (the reference's
    ``_moe_dispatch``): kept claims are scattered into (E * cap, D)
    buffers per group (one spare row takes every dropped claim), the
    experts run batched over (n_groups, E, cap, D), and each token sums
    its kept claims' outputs weighted by their routing probabilities.

    ``token_mask`` (N,) bool: dead tokens neither claim a capacity position
    nor combine."""
    n, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    if token_mask is None:
        token_mask = torch.ones((n,), dtype=torch.bool, device=x2d.device)
    idx, kept, cap = _claims(top_i, token_mask.bool(), cfg, n)
    n_groups, kg = idx.shape
    gsz = kg // k
    pad = n_groups * gsz - n
    if pad:
        x2d = F.pad(x2d, (0, 0, 0, pad))
        top_p = F.pad(top_p, (0, 0, 0, pad))
    ga = _group_axes(n_groups)
    xs = x2d.reshape(n_groups, 1, gsz, d).expand(n_groups, k, gsz, d).reshape(
        n_groups, kg, d)
    xs = maybe_constrain(xs, ga, None, None)
    idx = maybe_constrain(idx, ga, None)
    # expert weights enter the dispatch gathered over the FSDP axis; with
    # the groups over the whole mesh they are whole, else d_ff stays on tp
    w_tp = None if "tp" in ga else "tp"
    pw = {"w_gate": maybe_constrain(p["w_gate"], None, None, w_tp),
          "w_up": maybe_constrain(p["w_up"], None, None, w_tp),
          "w_down": maybe_constrain(p["w_down"], None, w_tp, None)}
    # ``new_zeros``: a DTensor when x2d is one, so the in-place scatter
    # below writes into a DTensor under a mesh
    xb = maybe_constrain(x2d.new_zeros((n_groups, e * cap + 1, d)), ga, None, None)
    xb.scatter_(1, idx[..., None].expand(n_groups, kg, d), xs)
    yb = _experts(pw, xb[:, :e * cap].reshape(n_groups, e, cap, d)).reshape(
        n_groups, e * cap, d)
    yb = maybe_constrain(yb, ga, None, None)
    yt = torch.gather(yb, 1, torch.clamp(idx, max=e * cap - 1)[..., None].expand(
        n_groups, kg, d))
    w = top_p.reshape(n_groups, gsz, k).transpose(1, 2).reshape(n_groups, kg, 1)
    w = maybe_constrain(w, ga, None, None)
    contrib = yt * kept[..., None].to(yt.dtype) * w.to(yt.dtype)
    y = contrib.reshape(n_groups, k, gsz, d).sum(dim=1)
    y = maybe_constrain(y, ga, None, None).reshape(n_groups * gsz, d)
    return y[:n]


def _token_mask(active: Optional[torch.Tensor], b: int, t: int) -> Optional[torch.Tensor]:
    """``active``, a per-row (B,) or per-token (B, T) mask, as (B * T,)."""
    if active is None:
        return None
    act = active.bool()
    return act.reshape(b * t) if act.ndim == 2 else act.repeat_interleave(t)


def moe_apply(p: Params, x: torch.Tensor, cfg: MoEConfig, ctx: QuantContext = NO_QUANT,
              name: str = "moe", active: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, D) -> (y, aux losses). ``active``: optional bool mask,
    per row (B,) or per token (B, T) (a chunked-prefill tick, whose rows'
    padding tails are dead); dead tokens are masked out of the combine and
    the capacity accounting, and their own outputs are garbage either way
    (the serving engine drops their state writes)."""
    b, t, d = x.shape
    x2d = ctx.act(name + "/in", x.reshape(b * t, d))
    top_p, top_i, aux = _router(p, x2d, cfg)
    token_mask = _token_mask(active, b, t)
    if token_mask is not None:
        top_p = top_p * token_mask[:, None].to(top_p.dtype)
    if cfg.exec_mode == "dense":
        y = _moe_dense(p, x2d, top_p, top_i, cfg)
    else:
        y = _moe_dispatch(p, x2d, top_p, top_i, cfg, token_mask=token_mask)
    if cfg.n_shared_experts > 0:
        y = y + mlp_apply(p["shared"], x2d, cfg.mlp_kind, ctx, name + "/shared")
    y = ctx.act(name + "/out", y)
    return y.reshape(b, t, d), aux


def dropped_claims(p: Params, x: torch.Tensor, cfg: MoEConfig, ctx: QuantContext = NO_QUANT,
                   name: str = "moe", active: Optional[torch.Tensor] = None) -> int:
    """How many live (token, slot) claims ``moe_apply`` in dispatch mode
    drops on these inputs (0 in dense mode, which has no capacity). For
    printouts and tests; it reads the count back from the device."""
    if cfg.exec_mode == "dense":
        return 0
    b, t, d = x.shape
    with torch.no_grad():
        x2d = ctx.act(name + "/in", x.reshape(b * t, d))
        _, top_i, _ = _router(p, x2d, cfg)
        mask = _token_mask(active, b, t)
        if mask is None:
            mask = torch.ones((b * t,), dtype=torch.bool, device=x.device)
        _, kept, _ = _claims(top_i, mask, cfg, b * t)
        return int(mask.sum()) * cfg.top_k - int(kept.sum())


def dispatch_ref(p: Params, x: torch.Tensor, cfg: MoEConfig,
                 active: Optional[torch.Tensor] = None, order: str = "slot"
                 ) -> Tuple[torch.Tensor, int]:
    """The routed output of dispatch mode as a plain yardstick: a host
    loop replays the claims one by one in slot-major order within each
    group (a claim is kept while its expert holds fewer than ``cap``),
    then the dense path combines with every dropped (token, slot) weight
    zeroed. Returns ((B, T, D) routed output without the shared experts,
    number of dropped claims). ``order="token"`` replays them token-major
    instead (every choice of a token before the next token's): not the
    reference's rule, a control that a check must tell apart."""
    b, t, d = x.shape
    n, e, k = b * t, cfg.n_experts, cfg.top_k
    x2d = x.reshape(n, d)
    top_p, top_i, _ = _router(p, x2d, cfg)
    mask = _token_mask(active, b, t)
    live = [True] * n if mask is None else mask.cpu().tolist()
    gsz, n_groups, cap = dispatch_capacity(cfg, n)
    experts = top_i.cpu().tolist()
    keep = torch.zeros((n, k), dtype=torch.bool)
    for g in range(n_groups):
        held = [0] * e
        toks = range(g * gsz, min((g + 1) * gsz, n))
        claims = [(tok, slot) for slot in range(k) for tok in toks] if order == "slot" \
            else [(tok, slot) for tok in toks for slot in range(k)]
        for tok, slot in claims:
            ex = experts[tok][slot]
            if live[tok] and held[ex] < cap:
                held[ex] += 1
                keep[tok, slot] = True
    live_t = torch.tensor(live, dtype=torch.bool)
    dropped = int(live_t.sum()) * k - int(keep.sum())
    keep = (keep & live_t[:, None]).to(top_p.device)
    y = _moe_dense(p, x2d, top_p * keep.to(top_p.dtype), top_i, cfg)
    return y.reshape(b, t, d), dropped
