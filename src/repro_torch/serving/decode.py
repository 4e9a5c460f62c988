"""The serving tick and its samplers (port of ``repro.serving.decode``,
the parts the continuous batcher runs).

``step_rows_full`` runs one ``model_apply`` over a (B, T) token block in
which every row sits at its own position ``pos[b]`` and contributes
``counts[b]`` real tokens (the rest is padding whose cache writes are
dropped). ``make_mixed_step`` and ``make_spec_step`` build the batcher's
tick from it: plain callables, since PyTorch runs eagerly.

Sampling rule: the token that will sit at logical position p is a pure
function of (request key, p) and that position's logits, so a
recomputed or speculated continuation resamples identical tokens. As in
the JAX package it is drawn with ``categorical(fold_in(key, p),
logits / temperature)`` over threefry (``repro_torch.random``, whose keys
and bits are JAX's); a request's key is ``PRNGKey(seed)``. Greedy
decoding (``temperature == 0``) is argmax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.transformer import ModelConfig, model_apply
from repro_torch.quant.qconfig import NO_QUANT, QuantContext
from repro_torch.random import PRNGKey, categorical, fold_in


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 => greedy
    top_k: Optional[int] = None    # sample only among the k best logits
    eos_id: Optional[int] = None   # a row stops after emitting this token
    pad_id: int = 0                # fills positions after EOS


def sample_logits(logits: torch.Tensor, gen: GenerateConfig,
                  keys: Optional[torch.Tensor] = None,
                  target_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, vocab) logits -> (B,) int64 tokens. Sampling (temperature > 0)
    needs per-row ``keys`` ((B,) request seeds) and ``target_pos``: row b
    draws ``categorical(fold_in(PRNGKey(seed_b), pos_b), logits_b /
    temperature)`` after the top-k cut, as the reference's
    ``sample_token_at`` does under the request key ``PRNGKey(seed)``."""
    if gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if keys is None or target_pos is None:
        raise ValueError("sampling needs per-row keys and target positions "
                         "when temperature > 0")
    dev = logits.device
    if gen.top_k is not None and 0 < gen.top_k < logits.shape[-1]:
        kth = torch.topk(logits, gen.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -float("inf"), logits)
    keys = fold_in(PRNGKey(torch.as_tensor(keys, device=dev).long()),
                   torch.as_tensor(target_pos, device=dev).long())
    # a divisor tensor on the logits' device: a true f32 division on CUDA
    temp = torch.full((), gen.temperature, dtype=logits.dtype, device=dev)
    return categorical(keys, logits / temp)


def sample_rows(logits: torch.Tensor, gen: GenerateConfig, keys: torch.Tensor,
                target_pos: torch.Tensor) -> torch.Tensor:
    """Per-row sampler of the mixed tick: (B, vocab) logits, (B,) request
    seeds, (B,) target positions -> (B,) tokens."""
    return sample_logits(logits, gen, keys, target_pos)


def sample_rows_all(logits: torch.Tensor, gen: GenerateConfig,
                    keys: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Every-position sampler of the speculative tick: (B, T, vocab)
    logits -> (B, T) tokens, entry [b, j] being the token plain decoding
    would place at position ``pos[b] + j + 1``."""
    b, t, v = logits.shape
    if gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    tpos = pos.to(logits.device)[:, None] + 1 + \
        torch.arange(t, device=logits.device)[None, :]
    rows = sample_logits(logits.reshape(b * t, v), gen,
                         keys.to(logits.device).repeat_interleave(t),
                         tpos.reshape(-1))
    return rows.reshape(b, t)


def step_rows_full(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                   pos: torch.Tensor, counts: torch.Tensor,
                   paged_live_width: Optional[int] = None,
                   paged_live_widths: Optional[torch.Tensor] = None,
                   ctx: QuantContext = NO_QUANT):
    """Variable-Tq fused step returning ALL positions' logits (B, T,
    vocab) and the (in place updated) cache. Row b holds ``counts[b]``
    real tokens at positions ``pos[b]..``; padding tokens write nothing.
    ``ctx`` in 'int8' mode makes it the W8A8 tick."""
    t = tokens.shape[1]
    active = torch.arange(t, device=tokens.device)[None, :] < counts[:, None]
    logits, aux = model_apply(params, cfg, {"tokens": tokens}, ctx=ctx, cache=cache,
                              pos=pos, active=active,
                              paged_live_width=paged_live_width,
                              paged_live_widths=paged_live_widths)
    return logits, aux["cache"]


def step_rows(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
              pos: torch.Tensor, counts: torch.Tensor,
              paged_live_width: Optional[int] = None,
              paged_live_widths: Optional[torch.Tensor] = None,
              ctx: QuantContext = NO_QUANT):
    """``step_rows_full`` keeping only each row's LAST real token's logits:
    returns (last_logits (B, vocab), cache)."""
    logits, cache = step_rows_full(params, cfg, cache, tokens, pos, counts,
                                   paged_live_width, paged_live_widths, ctx)
    idx = torch.clamp(counts - 1, min=0)
    last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
    return last, cache


def make_mixed_step(cfg: ModelConfig, gen: GenerateConfig,
                    ctx: QuantContext = NO_QUANT):
    """The batcher's tick: one ``step_rows`` forward advancing every
    runnable row (decode rows by 1 token, prefill rows by a chunk), then
    position-keyed sampling of each row's next token. ``ctx`` carries the
    calibrated int8 ranges of the W8A8 tick as python floats."""

    def mixed_step(params, cache, tokens, pos, counts, keys, live_width,
                   live_widths):
        last, cache = step_rows(params, cfg, cache, tokens, pos, counts,
                                paged_live_width=live_width,
                                paged_live_widths=live_widths, ctx=ctx)
        return sample_rows(last, gen, keys, pos + counts), cache

    return mixed_step


def make_spec_step(cfg: ModelConfig, gen: GenerateConfig,
                   ctx: QuantContext = NO_QUANT):
    """The speculative tick: one ``step_rows_full`` forward verifying up to
    k drafts per decode row, returning the (B, T) target-token matrix.
    Rejected drafts have written their K/V; that is sound because every
    read masks keys by logical position and the row's next writes replace
    them with identical bits (see ``repro.serving.decode.make_spec_step``)."""

    def spec_step(params, cache, tokens, pos, counts, keys, live_width,
                  live_widths):
        logits, cache = step_rows_full(params, cfg, cache, tokens, pos, counts,
                                       paged_live_width=live_width,
                                       paged_live_widths=live_widths, ctx=ctx)
        return sample_rows_all(logits, gen, keys, pos), cache

    return spec_step
