"""Decoder transformer over a dense or a paged KV cache (port of
``repro.models.transformer``).

One ``ModelConfig`` — the same fields and defaults as the JAX package's —
describes the model; the paper's knobs (``softmax_cfg``, ``gate_cfg``)
apply to every attention block. Params are nested dicts of tensors in the
JAX layout: scanned configs stack their layer groups along a leading axis
under ``"groups"``, unrolled ones keep a ``"layers"`` list, and a depth
the pattern does not divide keeps its last blocks, always unrolled, under
``"tail"``.

Block kinds: ``attn`` (global attention), ``local_attn`` (windowed
attention, over a per-row ring when the cache has one), ``griffin`` (the
RG-LRU recurrent block, ``repro_torch.nn.recurrent``) and ``mlstm`` /
``slstm`` (the xLSTM blocks, ``repro_torch.nn.xlstm``), in any pattern;
``embed_scale`` multiplies the embeddings by sqrt(d_model);
``pos="learned"`` adds a learned position table (BERT, OPT) and
``norm_position="post"`` normalizes after each residual add (BERT);
``post_block_norm`` normalizes each sub-block's output before its
residual add (gemma-2's sandwich norms). ``input_kind`` "embeds" feeds
precomputed embeddings (through ``frontend_proj`` when ``frontend_dim``
is set; the head is then always an untied ``lm_head``), "mixed" a prefix
of embeddings at ``d_model`` before the token embeddings.

This port covers the serving and evaluation paths: ``model_apply``
without a cache (the ``attention`` dispatcher: the flash kernel on the
card), with a dense cache (``init_cache``: ``generate`` and the
``paged=False`` batcher) or a paged one (``init_paged_cache``), at a
shared scalar ``pos`` or per-row ``pos`` with a per-token ``active``
mask, with a ``QuantContext`` whose site names are the reference's byte
for byte (a block is named by its index inside the pattern,
``layer_attn0``, in every group; a tail block ``tail_griffin0``). With
``cfg.moe`` set, an attention block's MLP is a Mixture-of-Experts layer
(``repro_torch.nn.moe``) whose dispatch takes the forward's ``active``
mask, and ``aux["moe_aux"]`` sums its aux losses over the layers.

Cache writes update the cache IN PLACE (``aux["cache"]`` is the cache
that was passed in): the KV cache is the largest tensor of a serving
engine, and copying it every layer of every tick would double it. Dense
KV, ring KV, ring position ids and recurrent states are per row
("batch-led"), updated in place for the rows the ``active`` mask keeps;
a recurrent state whose dtype changes (the W8A8 tick's f32 conv history
over a bf16 leaf) replaces its leaf instead, as the reference's
functional update does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.attention import (
    AttentionConfig,
    attention,
    dense_attention,
    paged_attention,
)
from repro_torch.core.gating import GateConfig, gate_probs, init_gate
from repro_torch.core.softmax import ClippedSoftmaxConfig, softcap
from repro_torch.device import resolve_device
from repro_torch.nn.layers import (
    apply_rope,
    embedding_apply,
    embedding_attend,
    embedding_init,
    linear_apply,
    linear_init,
    norm_apply,
    norm_init,
    positional_embedding_apply,
    positional_embedding_init,
    rmsnorm_apply,
    rmsnorm_init,
    rope_angles,
)
from repro_torch.nn.mlp import mlp_apply, mlp_init
from repro_torch.nn.moe import MoEConfig, moe_apply, moe_init
from repro_torch.nn.recurrent import (
    griffin_block_apply,
    griffin_block_init,
    griffin_init_state,
)
from repro_torch.nn.module import (
    Params,
    split_keys,
    tree_map,
    tree_slice,
)
from repro_torch.nn.xlstm import (
    XLSTMConfig,
    mlstm_block_apply,
    mlstm_block_init,
    slstm_block_apply,
    slstm_block_init,
    xlstm_init_state,
)
from repro_torch.quant.kv_cache import kv_quant
from repro_torch.quant.qconfig import NO_QUANT, QuantContext


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None

    # block pattern (one "group"); kinds: attn | local_attn | griffin | mlstm | slstm
    pattern: Tuple[str, ...] = ("attn",)

    # attention
    causal: bool = True
    window: Optional[int] = None                # for local_attn kind
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    pos: str = "rope"                           # rope | learned | none
    rope_theta: float = 10000.0
    max_seq_len: int = 131072
    attn_chunk_size: int = 1024

    # norms / residual
    norm: str = "rmsnorm"                       # rmsnorm | layernorm
    norm_position: str = "pre"                  # pre | post (BERT)
    post_block_norm: bool = False               # gemma-2 sandwich norms

    # mlp
    mlp_kind: str = "swiglu"                    # gelu | gelu_tanh | swiglu | none
    moe: Optional[MoEConfig] = None

    # paper knobs
    softmax_cfg: ClippedSoftmaxConfig = ClippedSoftmaxConfig()
    gate_cfg: GateConfig = GateConfig(kind="none")

    # paged-KV read path: "auto" (the CUDA kernel for CUDA tensors, the
    # plain gather path for CPU tensors) | "kernel" | "gather"
    paged_backend: str = "auto"

    # embedding / io
    tie_embeddings: bool = True
    embed_scale: bool = False                   # gemma: * sqrt(d_model)
    input_kind: str = "tokens"                  # tokens | embeds | mixed
    frontend_dim: Optional[int] = None
    n_prefix_embeds: int = 0

    # sub-configs for non-attention mixers
    rglru: Optional[Any] = None                 # RGLRUConfig
    xlstm: Optional[XLSTMConfig] = None

    vocab_pad_to: int = 1

    # execution
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "nothing"
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    init_std: float = 0.02

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return (self.vocab_size + m - 1) // m * m

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    def attn_cfg(self, kind: str) -> AttentionConfig:
        return AttentionConfig(
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            d_head=self.head_dim, causal=self.causal,
            window=self.window if kind == "local_attn" else None,
            logit_softcap=self.attn_logit_softcap, softmax=self.softmax_cfg,
            chunk_size=self.attn_chunk_size)


_KINDS = {"attn", "local_attn", "griffin", "mlstm", "slstm"}


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a config the model cannot build: an unknown block kind, or a
    recurrent kind without its sub-config."""
    kinds = set(cfg.pattern) | set(cfg.tail_pattern)
    if kinds - _KINDS:
        raise ValueError(f"unknown block kinds {sorted(kinds - _KINDS)}")
    if "griffin" in kinds and cfg.rglru is None:
        raise ValueError("griffin blocks need cfg.rglru (an RGLRUConfig)")
    if kinds & {"mlstm", "slstm"} and cfg.xlstm is None:
        raise ValueError("mlstm/slstm blocks need cfg.xlstm (an XLSTMConfig)")


# ==========================================================================
# Positions and masks
# ==========================================================================
def _positions(pos, t: int, device) -> torch.Tensor:
    """Absolute positions of a length-``t`` block: (T,) for a scalar
    ``pos``, (B, T) for a per-row (B,) tensor."""
    p = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return p[..., None] + torch.arange(t, dtype=torch.int64, device=device)


def _token_mask(active, b: int, t: int) -> Optional[torch.Tensor]:
    """``active`` as a per-token (B, T) bool mask: per-row (B,) masks are
    broadcast over the row's tokens."""
    if active is None:
        return None
    act = torch.as_tensor(active)
    if act.ndim == 1:
        act = act[:, None]
    return torch.broadcast_to(act.bool(), (b, t))


def _paged_targets(table: torch.Tensor, tpos: torch.Tensor,
                   act_tok: Optional[torch.Tensor], nb: int, bs: int):
    """The masked paged write as explicit indices. Token (b, j) at logical
    position p goes to pool block ``table[b, p // bs]``, slot ``p % bs``;
    entries past the table, ``-1`` entries, padding tokens and dead rows
    are dropped by filtering them out (torch has no ``mode="drop"``
    scatter). Returns (row idx, token idx, block idx, slot idx)."""
    w = table.shape[-1]
    entry = tpos // bs
    phys = torch.gather(table.long(), 1, torch.clamp(entry, max=w - 1))
    keep = (entry < w) & (phys >= 0) & (phys < nb)
    if act_tok is not None:
        keep &= act_tok
    bi, ti = keep.nonzero(as_tuple=True)
    return bi, ti, phys[bi, ti], (tpos % bs)[bi, ti]


def _paged_write(cache: dict, k: torch.Tensor, v: torch.Tensor, targets
                 ) -> None:
    """Write the kept tokens of (B, T, Hkv, Dh) ``k``/``v`` into the pools
    at ``targets`` (from ``_paged_targets``), in place. An int8 pool
    quantizes each token exactly once, here, and stores its scale beside
    it, so stored bits are a pure function of (value, position)."""
    bi, ti, blk, slot = targets
    if "k_scale" in cache:
        for name, x in (("k", k), ("v", v)):
            q, scale = kv_quant(x[bi, ti])
            cache[name][blk, slot] = q
            cache[name + "_scale"][blk, slot] = scale
    else:
        cache["k"][blk, slot] = k[bi, ti].to(cache["k"].dtype)
        cache["v"][blk, slot] = v[bi, ti].to(cache["v"].dtype)


def _row_targets(tpos: torch.Tensor, act_tok: Optional[torch.Tensor], length: int,
                 ring: bool):
    """The masked per-row write as explicit indices: token (b, j) at
    position p goes to slot ``p % length`` of row b's ring, or to slot p
    of its dense row; padding tokens, dead rows and (dense) positions at
    or past ``length`` are dropped, as the reference's scatter with
    ``mode="drop"`` drops them. Returns (row idx, token idx, slot idx)."""
    keep = torch.ones_like(tpos, dtype=torch.bool) if ring else tpos < length
    if act_tok is not None:
        keep = keep & act_tok
    bi, ti = keep.nonzero(as_tuple=True)
    slot = tpos % length if ring else tpos
    return bi, ti, slot[bi, ti]


def _slice_start(pos: int, t: int, length: int) -> int:
    """Where a shared-``pos`` write of ``t`` tokens lands in a row of
    ``length`` slots. The reference writes with ``dynamic_update_slice``,
    which clamps its start into [0, length - t]; this reproduces the clamp
    (a write past the row's end moves back to end at its last slot)."""
    if t > length:
        raise ValueError(f"a block of {t} tokens does not fit a cache row of {length}")
    return min(max(pos, 0), length - t)


def _ring_attention(cache: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    acfg: AttentionConfig, cfg: ModelConfig, tpos: torch.Tensor,
                    act_tok: Optional[torch.Tensor], targets,
                    gate_pi: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-row ring (``local_attn``) write and read, the reference's
    ``transformer.py:370-427``. ``tpos`` (B, T) are the tokens' positions.
    Decode (T == 1) writes first and reads the updated ring: the fresh
    token never evicts in-window history. A chunk (T > 1) can evict
    history that its earlier queries still need, so it reads the PRE-write
    ring concatenated with the fresh chunk (padding tagged -1), and the
    clipped softmax's gamma is pinned to the ring length, the axis every
    other ring read resolves it from. The position-id mask picks the
    in-window, causal, live keys of both."""
    length = cache["k"].shape[1]
    t = q.shape[1]
    bi, ti, slot = targets

    def write():
        cache["k"][bi, slot] = k[bi, ti].to(cache["k"].dtype)
        cache["v"][bi, slot] = v[bi, ti].to(cache["v"].dtype)
        cache["pos_ids"][bi, slot] = tpos[bi, ti].to(cache["pos_ids"].dtype)

    if t == 1:
        write()
        kp = cache["pos_ids"].long()[:, None, :]                   # (B, 1, L)
        k_all, v_all = cache["k"], cache["v"]
    else:
        fpos = tpos if act_tok is None else torch.where(act_tok, tpos, -1)
        kp = torch.cat([cache["pos_ids"].long(), fpos], dim=1)[:, None, :]
        k_all = torch.cat([cache["k"], k.to(cache["k"].dtype)], dim=1)
        v_all = torch.cat([cache["v"], v.to(cache["v"].dtype)], dim=1)
        if not acfg.softmax.is_vanilla:
            acfg = dataclasses.replace(acfg, softmax=ClippedSoftmaxConfig(
                gamma=acfg.softmax.resolve_gamma(length), zeta=acfg.softmax.zeta))
        write()
    q_pos = tpos[:, :, None]
    mask = (kp >= 0) & (kp <= q_pos) & (kp > q_pos - cfg.window)   # (B, T, Tk)
    return dense_attention(q, k_all, v_all, acfg, mask=mask, gate_pi=gate_pi)


def _ring_attention_shared(cache: dict, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, acfg: AttentionConfig, cfg: ModelConfig,
                           pos: int, gate_pi: Optional[torch.Tensor]) -> torch.Tensor:
    """Ring write and read at a shared scalar ``pos``, the reference's
    ``transformer.py:428-443`` (``generate``'s one-shot prefill and its
    decode steps): every row writes its block's K/V and position ids at
    slot ``pos % L`` (clamped as ``_slice_start`` says), then every query
    reads the UPDATED ring through the position-id mask, for T > 1 too.
    The per-row chunk path (``_ring_attention``) reads the pre-write ring
    plus the chunk instead; the two are different functions in the
    reference, and stay apart here."""
    length = cache["k"].shape[1]
    t = q.shape[1]
    s0 = _slice_start(pos % length, t, length)
    tpos = pos + torch.arange(t, device=q.device)
    cache["k"][:, s0:s0 + t] = k.to(cache["k"].dtype)
    cache["v"][:, s0:s0 + t] = v.to(cache["v"].dtype)
    cache["pos_ids"][:, s0:s0 + t] = tpos.to(cache["pos_ids"].dtype)
    kp = cache["pos_ids"].long()[:, None, :]                       # (B, 1, L)
    q_pos = tpos[None, :, None]                                    # (1, T, 1)
    mask = (kp >= 0) & (kp <= q_pos) & (kp > q_pos - cfg.window)   # (B, T, L)
    return dense_attention(q, cache["k"], cache["v"], acfg, mask=mask, gate_pi=gate_pi)


# ==========================================================================
# Block init / apply
# ==========================================================================
def _attn_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ks = split_keys(gen, 8)
    std, dt, dev = cfg.init_std, cfg.param_dtype, gen.device
    bias = cfg.norm == "layernorm"
    p: Params = {
        "ln1": norm_init(cfg.norm, d, dt, dev),
        "q": linear_init(ks[0], d, hq * dh, bias=bias, std=std, dtype=dt),
        "k": linear_init(ks[1], d, hkv * dh, bias=bias, std=std, dtype=dt),
        "v": linear_init(ks[2], d, hkv * dh, bias=bias, std=std, dtype=dt),
        "o": linear_init(ks[3], hq * dh, d, bias=bias, std=std, dtype=dt),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(dh, dt, dev)
        p["knorm"] = rmsnorm_init(dh, dt, dev)
    if cfg.gate_cfg.enabled:
        p["gate"] = init_gate(ks[4], cfg.gate_cfg, hq, dh, d, dt)
    if cfg.mlp_kind != "none":
        p["ln2"] = norm_init(cfg.norm, d, dt, dev)
        if cfg.moe is not None:
            p["moe"] = moe_init(ks[5], d, cfg.moe, dt)
        else:
            p["mlp"] = mlp_init(ks[5], d, cfg.d_ff, cfg.mlp_kind, dt)
    if cfg.post_block_norm:
        p["post_ln1"] = norm_init(cfg.norm, d, dt, dev)
        if cfg.mlp_kind != "none":
            p["post_ln2"] = norm_init(cfg.norm, d, dt, dev)
    return p


def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    if kind in ("attn", "local_attn"):
        return _attn_block_init(gen, cfg)
    dt, dev = cfg.param_dtype, gen.device
    if kind in ("mlstm", "slstm"):
        init = mlstm_block_init if kind == "mlstm" else slstm_block_init
        return {"ln": norm_init(cfg.norm, cfg.d_model, dt, dev),
                "blk": init(gen, cfg.xlstm, dt)}
    g1, g2, _ = split_keys(gen, 3)
    return {"ln1": norm_init(cfg.norm, cfg.d_model, dt, dev),
            "griffin": griffin_block_init(g1, cfg.d_model, cfg.rglru, dt),
            "ln2": norm_init(cfg.norm, cfg.d_model, dt, dev),
            "mlp": mlp_init(g2, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dt)}


class _Step:
    """What every block of one forward shares: positions, RoPE, the token
    mask, its per-row reduction, and the write indices (computed once per
    forward and cache layout, then reused by every layer)."""

    def __init__(self, cfg: ModelConfig, b: int, t: int, pos, active, device,
                 paged_live_width, paged_live_widths):
        self.pos = pos.to(device) if isinstance(pos, torch.Tensor) else pos
        self.tpos = torch.broadcast_to(_positions(self.pos, t, device), (b, t))
        self.rope = rope_angles(_positions(self.pos, t, device), cfg.head_dim,
                                cfg.rope_theta) if cfg.pos == "rope" else None
        self.act_tok = _token_mask(active, b, t)
        if self.act_tok is not None:
            self.act_tok = self.act_tok.to(device)
        # recurrent states have no per-token write index: a row keeps its
        # new state if ANY of its tokens is live (the reference's
        # _row_active); the scheduler feeds recurrent rows uniform steps
        self.act_row = None if self.act_tok is None else self.act_tok.any(dim=1)
        self.per_row = isinstance(self.pos, torch.Tensor) and self.pos.ndim >= 1
        if not self.per_row:
            # a shared start: a python int, read back once per forward
            self.pos = int(self.pos)
        self.live_width = paged_live_width
        self.live_widths = paged_live_widths
        self.write_idx: Dict = {}
        # the MoE layers' aux losses, summed in layer order
        self.moe_aux = {k: torch.zeros((), dtype=torch.float32, device=device)
                        for k in ("load_balance", "router_z")}


def _attn_block_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
    cache: Optional[dict], st: _Step, ctx: QuantContext, name: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_out, attention-layer output): the residual-stream value
    after the attention sub-block (after ``ln1`` in a post-norm block),
    the tensor whose outliers the paper measures. A MoE layer adds its aux
    losses to ``st.moe_aux``."""
    b, t, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    acfg = cfg.attn_cfg(kind)
    post = cfg.norm_position == "post"

    h = x if post else norm_apply(cfg.norm, p["ln1"], x, ctx, name + "/ln1")
    q = linear_apply(p["q"], h, ctx, name + "/q").reshape(b, t, hq, dh)
    k = linear_apply(p["k"], h, ctx, name + "/k").reshape(b, t, hkv, dh)
    v = linear_apply(p["v"], h, ctx, name + "/v").reshape(b, t, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["qnorm"], q, ctx=ctx, name=name + "/qnorm")
        k = rmsnorm_apply(p["knorm"], k, ctx=ctx, name=name + "/knorm")
    if st.rope is not None:
        q = apply_rope(q, *st.rope)
        k = apply_rope(k, *st.rope)

    gate_pi = None
    if cfg.gate_cfg.enabled:
        # per-head view of the attention input (paper Sec 4.2); when
        # n_heads*d_head != d_model the per-head query is the view instead
        x_heads = h.reshape(b, t, hq, dh) if hq * dh == d else q
        gate_pi = gate_probs(p["gate"], cfg.gate_cfg, x_heads, h)

    if cache is None:
        attn_out = attention(q, k, v, acfg, q_offset=0, gate_pi=gate_pi)
    elif "block_table" in cache:
        nb, bs = cache["k"].shape[0], cache["k"].shape[1]
        table = cache["block_table"]
        key = (table.data_ptr(), tuple(table.shape), table.stride())
        if key not in st.write_idx:
            st.write_idx[key] = _paged_targets(table, st.tpos, st.act_tok, nb, bs)
        _paged_write(cache, k, v, st.write_idx[key])
        scales = {n: cache[n] for n in ("k_scale", "v_scale") if n in cache}
        attn_out = paged_attention(
            q, cache["k"], cache["v"], table, acfg, q_offset=st.pos,
            gate_pi=gate_pi, live_width=st.live_width,
            live_widths=st.live_widths, backend=cfg.paged_backend, **scales)
    elif "pos_ids" in cache and not st.per_row:
        attn_out = _ring_attention_shared(cache, q, k, v, acfg, cfg, st.pos, gate_pi)
    elif "pos_ids" in cache:
        key = ("ring", cache["k"].shape[1])
        if key not in st.write_idx:
            st.write_idx[key] = _row_targets(st.tpos, st.act_tok, key[1], ring=True)
        attn_out = _ring_attention(cache, q, k, v, acfg, cfg, st.tpos, st.act_tok,
                                   st.write_idx[key], gate_pi)
    else:
        # a dense row of max_len slots (the reference's :370-387 and
        # :444-449): a masked per-token scatter at per-row positions, or a
        # slice write at a shared one; then every query reads the whole
        # row, causally, at its own offset (on the card: the flash kernel)
        length = cache["k"].shape[1]
        if st.per_row:
            key = ("row", length)
            if key not in st.write_idx:
                st.write_idx[key] = _row_targets(st.tpos, st.act_tok, length, ring=False)
            bi, ti, slot = st.write_idx[key]
            cache["k"][bi, slot] = k[bi, ti].to(cache["k"].dtype)
            cache["v"][bi, slot] = v[bi, ti].to(cache["v"].dtype)
        else:
            s0 = _slice_start(st.pos, t, length)
            cache["k"][:, s0:s0 + t] = k.to(cache["k"].dtype)
            cache["v"][:, s0:s0 + t] = v.to(cache["v"].dtype)
        attn_out = attention(q, cache["k"], cache["v"], acfg, q_offset=st.pos,
                             gate_pi=gate_pi)

    attn_out = ctx.act(name + "/attn.out", attn_out.reshape(b, t, hq * dh))
    y = linear_apply(p["o"], attn_out, ctx, name + "/o")
    if cfg.post_block_norm:
        y = norm_apply(cfg.norm, p["post_ln1"], y, ctx, name + "/post_ln1")
    x = x + y
    if post:
        x = norm_apply(cfg.norm, p["ln1"], x, ctx, name + "/ln1")
    attn_layer_out = x
    if cfg.mlp_kind != "none":
        h2 = x if post else norm_apply(cfg.norm, p["ln2"], x, ctx, name + "/ln2")
        if cfg.moe is not None:
            # dead tokens (inactive rows, padding tails) claim no capacity
            y2, moe_aux = moe_apply(p["moe"], h2, cfg.moe, ctx, name + "/moe",
                                    active=st.act_tok)
            for k in st.moe_aux:
                st.moe_aux[k] = st.moe_aux[k] + moe_aux[k]
        else:
            y2 = mlp_apply(p["mlp"], h2, cfg.mlp_kind, ctx, name + "/mlp")
        if cfg.post_block_norm:
            y2 = norm_apply(cfg.norm, p["post_ln2"], y2, ctx, name + "/post_ln2")
        x = x + y2
        if post:
            x = norm_apply(cfg.norm, p["ln2"], x, ctx, name + "/ln2")
    return x, attn_layer_out


def _griffin_block_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Optional[dict],
    st: _Step, ctx: QuantContext, name: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_out, mixer output): the residual value after the
    recurrent sub-block. With a cache, the rows ``st.act_row`` keeps take
    their new recurrent state (h, conv), in place."""
    h = norm_apply(cfg.norm, p["ln1"], x, ctx, name + "/ln1")
    y, new_state = griffin_block_apply(p["griffin"], h, cfg.rglru, cache, ctx,
                                       name + "/griffin")
    if cache is not None:
        _store_state(cache, new_state, st.act_row)
    x = x + y
    mix_out = x
    h2 = norm_apply(cfg.norm, p["ln2"], x, ctx, name + "/ln2")
    x = x + mlp_apply(p["mlp"], h2, cfg.mlp_kind, ctx, name + "/mlp")
    return x, mix_out


def _xlstm_block_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str, cache: Optional[dict],
    st: _Step, ctx: QuantContext, name: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """An mLSTM or sLSTM block (the reference's :538-545): pre-norm, the
    block, the residual add; the residual value is also the mixer output.
    With a cache, the rows ``st.act_row`` keeps take their new state
    (conv history and cell), in place."""
    h = norm_apply(cfg.norm, p["ln"], x, ctx, name + "/ln")
    fn = mlstm_block_apply if kind == "mlstm" else slstm_block_apply
    y, new_state = fn(p["blk"], h, cfg.xlstm, cache, ctx, f"{name}/{kind}")
    if cache is not None:
        _store_state(cache, new_state, st.act_row)
    x = x + y
    return x, x


def _store_state(cache: dict, new_state: dict, act_row: Optional[torch.Tensor]) -> None:
    """Write a recurrent block's new state into ``cache``, keeping the old
    state of the rows ``act_row`` masks off (the reference's
    ``_row_select``). A leaf takes the new state's dtype, as the
    reference's functional update does: under W8A8 the int8 GEMMs return
    f32, so a bf16 model's conv history turns f32 after its first tick,
    and an in-place copy into the bf16 leaf would round it. Such a leaf is
    replaced in its dict; a leaf of a stacked (scanned) cache is a view
    and cannot change dtype, so that raises."""
    def keep_rows(new, old):
        if act_row is None:
            return new
        m = act_row.reshape(-1, *([1] * (new.ndim - 1)))
        return torch.where(m, new, old.to(new.dtype))

    for key, new in new_state.items():
        old = cache[key]
        if isinstance(new, tuple):      # an xLSTM cell: f32 leaves, in place
            for o, n in zip(old, new):
                o.copy_(keep_rows(n, o))
            continue
        new = keep_rows(new, old)
        if new.dtype == old.dtype:
            old.copy_(new)
        elif old._base is not None:
            raise ValueError(
                f"a recurrent state of dtype {new.dtype} cannot be stored into a "
                f"{old.dtype} leaf of a stacked cache: run the unrolled layers "
                f"(scan_layers=False), as the W8A8 engine does")
        else:
            cache[key] = new.clone()


def _block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 cache: Optional[dict], st: _Step, ctx: QuantContext, name: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    if kind == "griffin":
        return _griffin_block_apply(p, x, cfg, cache, st, ctx, name)
    if kind in ("mlstm", "slstm"):
        return _xlstm_block_apply(p, x, cfg, kind, cache, st, ctx, name)
    return _attn_block_apply(p, x, cfg, kind, cache, st, ctx, name)


# ==========================================================================
# Whole model
# ==========================================================================
def _stacked(make, n: int) -> Params:
    """Stack ``make(0) .. make(n-1)`` along a new leading axis, filling a
    preallocated stack one tree at a time so that at most one unstacked
    tree exists at once (the scanned ``groups`` layout of full-size
    models would otherwise need twice its weights in memory)."""
    first = make(0)
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    for i in range(n):
        tree = first if i == 0 else make(i)
        tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
    return out


def _assemble(cfg: ModelConfig, one) -> Params:
    """A params-shaped tree of ``one(kind, lead)``: the scanned ``groups``
    stack (lead = (n_groups,)) or the unrolled ``layers`` list, then the
    unrolled ``tail``."""
    out: Params = {}
    if cfg.scan_layers and cfg.n_groups > 0:
        out["groups"] = {f"b{i}": one(kind, (cfg.n_groups,))
                         for i, kind in enumerate(cfg.pattern)}
    else:
        out["layers"] = [{f"b{i}": one(kind, ()) for i, kind in enumerate(cfg.pattern)}
                         for _ in range(cfg.n_groups)]
    if cfg.tail_pattern:
        out["tail"] = {f"t{i}": one(kind, ()) for i, kind in enumerate(cfg.tail_pattern)}
    return out


def model_init(seed, cfg: ModelConfig, device="cuda") -> Params:
    """Random weights from ``seed`` (an int, or a ``torch.Generator`` on
    the target device), drawn on ``device``. The key tree mirrors the JAX
    package's, but the numbers differ: tests that compare the two
    packages convert the JAX weights (``repro_torch.convert``)."""
    check_supported(cfg)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
    keys = split_keys(gen, cfg.n_layers + 4)
    dt = cfg.param_dtype
    p: Params = {}
    if cfg.input_kind in ("tokens", "mixed"):
        p["embed"] = embedding_init(keys[-1], cfg.padded_vocab, cfg.d_model,
                                    cfg.init_std, dt)
    if cfg.input_kind in ("embeds", "mixed") and cfg.frontend_dim is not None:
        p["frontend_proj"] = linear_init(keys[-2], cfg.frontend_dim, cfg.d_model, dtype=dt)
    if cfg.pos == "learned":
        p["pos_embed"] = positional_embedding_init(keys[-3], cfg.max_seq_len,
                                                   cfg.d_model, dt)
    glen = len(cfg.pattern)

    def group(g: int) -> Params:
        return {f"b{i}": _block_init(keys[g * glen + i], cfg, kind)
                for i, kind in enumerate(cfg.pattern)}

    if cfg.scan_layers and cfg.n_groups > 0:
        p["groups"] = _stacked(group, cfg.n_groups)
    else:
        p["layers"] = [group(g) for g in range(cfg.n_groups)]
    if cfg.tail_pattern:
        p["tail"] = {f"t{i}": _block_init(keys[cfg.n_groups * glen + i], cfg, kind)
                     for i, kind in enumerate(cfg.tail_pattern)}
    p["final_norm"] = norm_init(cfg.norm, cfg.d_model, dt, gen.device)
    if not cfg.tie_embeddings or cfg.input_kind == "embeds":
        p["lm_head"] = linear_init(keys[-4], cfg.d_model, cfg.padded_vocab,
                                   bias=False, std=cfg.init_std, dtype=dt)
    return p


def _cache_entry(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                 device, lead: Tuple[int, ...] = ()) -> Params:
    """Dense decode state of one block (the reference's ``_cache_entry``),
    with the stacked groups' ``lead`` axes in front: K/V rows for attention
    blocks (a ring for ``local_attn``), recurrent states otherwise."""
    if kind in ("griffin", "mlstm", "slstm"):
        state = griffin_init_state(batch, cfg.rglru, dtype, device) if kind == "griffin" \
            else xlstm_init_state(batch, kind, cfg.xlstm, dtype, device)
        return tree_map(lambda v: v.expand(lead + tuple(v.shape)).clone(), state)
    # local attention only ever needs ``window`` history: a ring
    length = min(max_len, cfg.window) if (kind == "local_attn" and cfg.window) else max_len
    shape = lead + (batch, length, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "local_attn" and cfg.window and length < cfg.max_seq_len:
        # per-row ring positions (-1 = empty): rows decode at different offsets
        c["pos_ids"] = torch.full(lead + (batch, length), -1, dtype=torch.int32,
                                  device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Params:
    """Dense decode state, in the params' layout (scanned configs stack
    the groups in front, the tail is unrolled); every row reserves
    ``max_len`` positions up front, as in the reference:

      * ``attn``: ``k``/``v`` (batch, max_len, Hkv, Dh) in ``dtype``;
      * ``local_attn``: a ring ``k``/``v`` (batch, L, Hkv, Dh) of L =
        min(max_len, window) slots with ``pos_ids`` (batch, L) int32, -1 =
        empty, when L < max_seq_len; otherwise a plain dense row read with
        the window mask;
      * ``griffin``: the recurrent state ``h`` (batch, width) f32 and the
        conv history ``conv`` (batch, conv_width - 1, width);
      * ``mlstm`` / ``slstm``: the conv history ``conv`` and the f32 cell
        ``cell``, a tuple (C, n, m) / (c, n, m, h) (``xlstm_init_state``).

    ``init_paged_cache`` is the alternative whose memory scales with live
    tokens."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    return _assemble(cfg, lambda kind, lead: _cache_entry(cfg, kind, batch, max_len,
                                                          dtype, dev, lead))


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     num_blocks: int, block_size: int = 16, dtype=None,
                     kv_int8: bool = False, device="cuda") -> Params:
    """Paged decode state, in the params' layout (scanned configs stack
    the groups in front, the tail is unrolled):

      * ``attn``: a block pool ``k``/``v`` (num_blocks, block_size, Hkv,
        Dh) shared by all rows plus a per-row ``block_table`` (batch,
        max_len // block_size) of physical ids (-1 = unallocated);
        ``kv_int8=True`` stores int8 pools plus per-slot f32 scale vectors
        ``k_scale``/``v_scale`` (num_blocks, block_size);
      * every other kind: the dense per-row state of
        ``init_cache`` (a ring, or a dense row without a ring; recurrent
        state); it stays in ``dtype`` under ``kv_int8``, as in the
        reference."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    if max_len % block_size:
        raise ValueError(
            f"max_len={max_len} must be a multiple of block_size="
            f"{block_size}: the virtual KV length (table width * block_size) "
            f"must equal the logical cap, because softmax_cfg.alpha resolves "
            f"gamma = -alpha/T from it")
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    n_entries = max_len // block_size

    def one(kind: str, lead: Tuple[int, ...]) -> Params:
        if kind != "attn":
            return _cache_entry(cfg, kind, batch, max_len, dtype, dev, lead)
        pool_dtype = torch.int8 if kv_int8 else dtype
        shape = lead + (num_blocks, block_size, hkv, dh)
        c = {"k": torch.zeros(shape, dtype=pool_dtype, device=dev),
             "v": torch.zeros(shape, dtype=pool_dtype, device=dev),
             "block_table": torch.full(lead + (batch, n_entries), -1,
                                       dtype=torch.int32, device=dev)}
        if kv_int8:
            for name in ("k_scale", "v_scale"):
                c[name] = torch.zeros(lead + (num_blocks, block_size),
                                      dtype=torch.float32, device=dev)
        return c

    return _assemble(cfg, one)


def paged_kv_block_bytes(cfg: ModelConfig, block_size: int = 16,
                         kv_int8: bool = False, dtype=None) -> int:
    """Bytes ONE pool block costs per attention layer (k + v and, for
    int8, the two per-slot scale vectors)."""
    dtype = dtype or cfg.compute_dtype
    elems = block_size * cfg.n_kv_heads * cfg.head_dim
    if kv_int8:
        return 2 * elems * 1 + 2 * block_size * 4
    return 2 * elems * torch.empty((), dtype=dtype).element_size()


def paged_entries(cache: Params):
    """Every paged attention entry (a dict holding ``block_table``) of
    ``cache``, in layer order."""
    if isinstance(cache, dict):
        if "block_table" in cache:
            yield cache
            return
        for v in cache.values():
            yield from paged_entries(v)
    elif isinstance(cache, (list, tuple)):
        for v in cache:
            yield from paged_entries(v)


def row_leaves(cache: Params, path: Tuple = ()):
    """(path, leaf, batch axis) of every batch-led leaf of ``cache``: ring
    K/V and ``pos_ids``, recurrent ``h``/``conv``/``cell`` — every leaf outside a
    paged entry. Scanned caches stack the groups in front, so the batch is
    axis 1 under ``"groups"``, else 0."""
    if isinstance(cache, dict):
        if "block_table" in cache:
            return
        items = cache.items()
    elif isinstance(cache, (list, tuple)):
        items = enumerate(cache)
    else:
        yield path, cache, 1 if path[0] == "groups" else 0
        return
    for k, v in items:
        yield from row_leaves(v, path + (k,))


def copy_pool_blocks(cache: Params, src: torch.Tensor, dst: torch.Tensor
                     ) -> Params:
    """Copy physical pool blocks ``src[i] -> dst[i]`` in every paged pool
    of ``cache`` (K/V and, for int8 KV, their scale vectors), in place.
    All sources are gathered before any destination is written, so a
    pair whose source is another pair's destination still copies
    pre-copy content. Batch-led leaves (ring, recurrent state) are left
    alone. Returns ``cache``."""
    for entry in paged_entries(cache):
        stacked = entry["block_table"].ndim == 3        # scanned: (G, B, W)
        for name in ("k", "v", "k_scale", "v_scale"):
            leaf = entry.get(name)
            if leaf is None:
                continue
            if stacked:
                leaf[:, dst] = leaf[:, src]
            else:
                leaf[dst] = leaf[src]
    return cache


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  ctx: QuantContext) -> torch.Tensor:
    """The residual stream's input before learned positions, in the
    reference's order: the embeds (through ``frontend_proj`` when the
    params have one), then the token embeddings concatenated after them.
    A config whose ``input_kind`` takes neither part present raises."""
    parts = []
    if cfg.input_kind in ("embeds", "mixed") and "embeds" in batch:
        e = batch["embeds"].to(cfg.compute_dtype)
        if "frontend_proj" in params:
            e = linear_apply(params["frontend_proj"], e, ctx, "frontend_proj")
        parts.append(e)
    if cfg.input_kind in ("tokens", "mixed") and "tokens" in batch:
        scale = math.sqrt(cfg.d_model) if cfg.embed_scale else None
        parts.append(embedding_apply(params["embed"], batch["tokens"], ctx, "embed", scale
                                     ).to(cfg.compute_dtype))
    if not parts:
        raise ValueError(f"input_kind {cfg.input_kind!r} takes none of the batch's "
                         f"parts {sorted(batch)}")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def model_apply(
    params: Params,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    ctx: QuantContext = NO_QUANT,
    cache: Optional[Params] = None,
    pos: Any = 0,
    active: Optional[torch.Tensor] = None,
    collect_acts: bool = False,
    paged_live_width: Optional[int] = None,
    paged_live_widths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward pass. Returns (logits (B, T, vocab) f32, aux).

    ``batch``: {"tokens": (B, T) int} and/or {"embeds": (B, T, F)} as
    ``cfg.input_kind`` takes them (``_embed_inputs``: a mixed batch's
    embeds come first, and T counts both parts). ``cache``/``pos``: a dense
    (``init_cache``) or paged (``init_paged_cache``) cache and the block's
    start position, a shared int or a per-row (B,) tensor. ``active``:
    optional per-row (B,) or per-token (B, T) bool mask for per-row
    ``pos`` (a shared ``pos`` writes every row, as in the reference);
    masked tokens still compute, but their cache writes are dropped;
    recurrent blocks keep the
    new state of a row if any of its tokens is live, so ragged rows are
    for attention caches only (the scheduler feeds recurrent models
    uniform steps). ``paged_live_width`` bounds the paged read to the
    first N table entries, ``paged_live_widths`` masks each row's read at
    its own count. Without a cache the attention is dense, causal unless
    ``cfg.causal`` is False (BERT), windowed for ``local_attn``. ``ctx``
    quantizes at the reference's sites ('collect', 'apply') or runs the
    W8A8 linears ('int8');
    ``lm_head`` stays fp through ``QConfig.skip_patterns``. ``aux`` holds
    "cache" (the same, in-place updated cache) when one is given. As in
    the reference, the outlier telemetry depends on the layout: a scanned
    config (``scan_layers``) gives "act_stats", the (n_groups,
    len(pattern)) max |block output| of the groups (here for cache-free
    forwards, the ones that read it), and with ``collect_acts``
    "attn_outputs" lists the block outputs of the unrolled layers and of
    the tail (for a scanned config, the tail's only). "moe_aux" holds the
    MoE layers' ``load_balance`` and ``router_z`` summed over every layer
    and the tail (f32 zeros without MoE), as in the reference."""
    check_supported(cfg)
    x = _embed_inputs(params, cfg, batch, ctx)
    b, t, _ = x.shape
    dev = x.device
    st = _Step(cfg, b, t, pos, active, dev, paged_live_width, paged_live_widths)
    if cfg.pos == "learned":
        # a padded tail past the table reads NaN rows, as in the reference
        x = x + positional_embedding_apply(params["pos_embed"], st.tpos).to(x.dtype)

    scanned = cfg.scan_layers and cfg.n_groups > 0
    stats, acts = [], []
    for g in range(cfg.n_groups):
        gp = params["layers"][g] if "layers" in params \
            else tree_slice(params["groups"], g)
        gc = None
        if cache is not None:
            gc = cache["layers"][g] if "layers" in cache \
                else tree_slice(cache["groups"], g)
        gstats = []
        for i, kind in enumerate(cfg.pattern):
            x, a = _block_apply(gp[f"b{i}"], x, cfg, kind,
                                None if gc is None else gc[f"b{i}"], st, ctx,
                                f"layer_{kind}{i}")
            if scanned and cache is None:
                gstats.append(torch.amax(torch.abs(a)))
            elif not scanned and collect_acts:
                acts.append(a)
        if gstats:
            stats.append(torch.stack(gstats))
    for i, kind in enumerate(cfg.tail_pattern):
        x, a = _block_apply(params["tail"][f"t{i}"], x, cfg, kind,
                            None if cache is None else cache["tail"][f"t{i}"], st,
                            ctx, f"tail_{kind}{i}")
        if collect_acts:
            acts.append(a)

    x = norm_apply(cfg.norm, params["final_norm"], x, ctx, "final_norm")
    if "lm_head" in params:
        logits = linear_apply(params["lm_head"], x, ctx, "lm_head").float()
    else:
        logits = embedding_attend(params["embed"], x, ctx, "lm_head")
    logits = softcap(logits, cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=dev) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    aux: Dict[str, Any] = {"moe_aux": st.moe_aux}
    if stats:
        aux["act_stats"] = torch.stack(stats)
    if acts:
        aux["attn_outputs"] = acts
    if cache is not None:
        aux["cache"] = cache
    return logits, aux
