"""Serving decode (port of ``repro.serving.decode``): ``generate`` over
the dense cache, and the batcher's tick and samplers.

``generate`` prefills the prompt into a dense cache (``init_cache``) of
``max_len = T + max_new_tokens`` in one forward at a shared ``pos`` 0 —
or, for a prompt that overflows a ``local_attn`` ring, in chunks through
``step_rows`` — then decodes one token at a time in a plain Python loop
(PyTorch runs eagerly; the reference's ``lax.while_loop``): greedy,
temperature and top-k sampling, ``eos_id`` with a per-row finished mask
(later positions are ``pad_id``), and an early exit once every row is
done. ``prefill``, ``chunked_prefill`` and ``decode_one`` are its steps.

``step_rows_full`` runs one ``model_apply`` over a (B, T) token block in
which every row sits at its own position ``pos[b]`` and contributes
``counts[b]`` real tokens (the rest is padding whose cache writes are
dropped). ``make_mixed_step`` and ``make_spec_step`` build the batcher's
tick from it: plain callables, since PyTorch runs eagerly.

Two sampling rules, as in the reference, both over threefry
(``repro_torch.random``, whose keys and bits are JAX's):

  * ``generate`` splits ONE key per token (``key, sub = split(key)``
    before token 0 and before every later token) and draws the whole
    (B, vocab) block with ``sub``: ``sample_logits_one_key``.
  * the batcher draws the token that will sit at logical position p from
    ``categorical(fold_in(key, p), logits / temperature)`` with the
    request's key ``PRNGKey(seed)`` (``sample_token_at``;
    ``sample_logits`` per row), so a recomputed or speculated
    continuation resamples identical tokens.

Greedy decoding (``temperature == 0``) is argmax under both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.transformer import ModelConfig, init_cache, model_apply
from repro_torch.quant.qconfig import NO_QUANT, QuantContext
from repro_torch.random import PRNGKey, categorical, fold_in, gumbel, split


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 => greedy
    top_k: Optional[int] = None    # sample only among the k best logits
    eos_id: Optional[int] = None   # a row stops after emitting this token
    pad_id: int = 0                # fills positions after EOS


def _top_k_cut(logits: torch.Tensor, gen: GenerateConfig) -> torch.Tensor:
    """Logits below each row's k-th largest set to -inf (``top_k``)."""
    if gen.top_k is not None and 0 < gen.top_k < logits.shape[-1]:
        kth = torch.topk(logits, gen.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -float("inf"), logits)
    return logits


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
    logits = _top_k_cut(logits, gen)
    keys = fold_in(PRNGKey(torch.as_tensor(keys, device=dev).long()),
                   torch.as_tensor(target_pos, device=dev).long())
    # a divisor tensor on the logits' device: a true f32 division on CUDA
    temp = torch.full((), gen.temperature, dtype=logits.dtype, device=dev)
    return categorical(keys, logits / temp)


def sample_logits_one_key(logits: torch.Tensor, gen: GenerateConfig,
                          key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, vocab) logits -> (B,) int64 tokens under ONE raw key (2,) for
    the whole block, the reference's ``sample_logits``: after the top-k
    cut, ``categorical(key, logits / temperature)`` draws Gumbel noise of
    shape (B, vocab) from the one key (element (b, v) from bits of flat
    index b * vocab + v), not a key per row."""
    if gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if key is None:
        raise ValueError("sample_logits_one_key needs a PRNG key when temperature > 0")
    logits = _top_k_cut(logits, gen)
    temp = torch.full((), gen.temperature, dtype=logits.dtype, device=logits.device)
    noise = gumbel(torch.as_tensor(key).to(logits.device), logits.shape)
    return torch.argmax(noise.to(logits.dtype) + logits / temp, dim=-1)


def sample_token_at(logits: torch.Tensor, gen: GenerateConfig, key: torch.Tensor,
                    target_pos) -> torch.Tensor:
    """(vocab,) logits -> () token for ONE row, keyed by the token's
    absolute position: ``fold_in(key, target_pos)`` of the request's raw
    key (2,), so sampling is a pure function of (request seed, position)
    and a preempted request recomputed from its prompt resamples the
    identical continuation."""
    if gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    k = fold_in(torch.as_tensor(key).to(logits.device),
                torch.as_tensor(target_pos, device=logits.device).long())
    return sample_logits_one_key(logits[None], gen, k)[0]


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


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int):
    """Run the prompt through the model in one forward at ``pos`` 0,
    building a dense cache of ``max_len`` positions on the tokens' device.
    Returns (last_logits (B, vocab), cache, prompt_len)."""
    b, t = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    logits, aux = model_apply(params, cfg, {"tokens": tokens}, cache=cache, pos=0)
    return logits[:, -1, :], aux["cache"], t


def _ring_chunk_cap(cfg: ModelConfig, max_len: int) -> Optional[int]:
    """Largest prefill chunk a ``local_attn`` ring admits (the batcher's
    ``ring_cap``): a chunk must fit the ring and its own writes must not
    collide inside it. None when no layer uses a ring."""
    kinds = tuple(cfg.pattern) + tuple(cfg.tail_pattern)
    if any(k == "local_attn" for k in kinds) and cfg.window:
        return min(max_len, cfg.window)
    return None


def chunked_prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int,
                    chunk: Optional[int] = None):
    """Stream the prompt through ``step_rows`` in uniform chunks at per-row
    positions (the batcher's chunked-prefill contract), each capped at the
    ring, so ``local_attn`` prompts longer than the window prefill
    exactly. Returns (last_logits (B, vocab), cache, prompt_len)."""
    b, t = tokens.shape
    cap = _ring_chunk_cap(cfg, max_len)
    step = min(x for x in (chunk, cap, t) if x is not None and x > 0)
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    last = None
    for off in range(0, t, step):
        c = min(step, t - off)
        pos = torch.full((b,), off, dtype=torch.int64, device=tokens.device)
        counts = torch.full((b,), c, dtype=torch.int64, device=tokens.device)
        last, cache = step_rows(params, cfg, cache, tokens[:, off:off + c], pos, counts)
    return last, cache, t


def decode_one(params, cfg: ModelConfig, cache, tokens: torch.Tensor, pos,
               active: Optional[torch.Tensor] = None):
    """One decode step of (B, 1) ``tokens`` at ``pos``, a shared int or a
    per-row (B,) tensor; ``active`` masks the cache writes of dead rows.
    Returns (logits (B, vocab), cache)."""
    logits, aux = model_apply(params, cfg, {"tokens": tokens}, cache=cache, pos=pos,
                              active=active)
    return logits[:, -1, :], aux["cache"]


def _decode_loop(params, cfg: ModelConfig, cache, last_logits: torch.Tensor,
                 gen: GenerateConfig, pos: int, key: torch.Tensor):
    """The decode loop: returns ((B, max_new_tokens) int32 tokens, cache).
    Token 0 comes from the prefill logits and each later token from one
    decode step at ``pos + i - 1``, so no forward is spent on the last
    token. After EOS a row emits ``pad_id`` (its pad is still fed back, as
    in the reference); the loop stops once every row is done, which reads
    the finished mask back to the host only when ``eos_id`` is set."""
    b = last_logits.shape[0]
    n = gen.max_new_tokens
    dev = last_logits.device
    buf = torch.full((b, n), gen.pad_id, dtype=torch.int32, device=dev)
    if n == 0:
        return buf, cache
    key, sub = split(key)
    tok = sample_logits_one_key(last_logits, gen, sub)
    finished = tok == gen.eos_id if gen.eos_id is not None else None
    buf[:, 0] = tok.to(torch.int32)
    for i in range(1, n):
        if finished is not None and bool(finished.all()):
            break
        logits, cache = decode_one(params, cfg, cache, tok[:, None], pos + i - 1)
        key, sub = split(key)
        tok = sample_logits_one_key(logits, gen, sub)
        if finished is not None:
            tok = torch.where(finished, gen.pad_id, tok)
            finished = finished | (tok == gen.eos_id)
        buf[:, i] = tok.to(torch.int32)
    return buf, cache


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, gen: GenerateConfig,
             key: Optional[torch.Tensor] = None,
             prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Greedy / temperature / top-k generation. ``prompt``: (B, T) token
    ids on the params' device; the cache is made there. Returns (B, T + max_new_tokens) int32; rows that emit ``gen.eos_id``
    keep it and are padded with ``gen.pad_id`` afterwards. ``key`` is a
    raw threefry key (2,), ``PRNGKey(0)`` when None.

    Prompts that overflow a ``local_attn`` ring (T > window) prefill
    through the batcher's chunked path automatically; ``prefill_chunk``
    forces chunked prefill with that chunk size (still capped at the
    ring).

    The cache holds ``max_len = T + max_new_tokens`` positions, as in the
    reference, and the clipped softmax resolves ``gamma = -alpha / len``
    from that length. So a clipped ``generate`` and a batcher whose
    ``max_len`` differs compute different functions (the reference's own
    batcher-vs-generate test fails on it); compare clipped runs only at
    equal ``max_len``."""
    t = prompt.shape[1]
    max_len = t + gen.max_new_tokens
    cap = _ring_chunk_cap(cfg, max_len)
    key = PRNGKey(0, device=prompt.device) if key is None else key
    with torch.no_grad():
        if prefill_chunk is None and (cap is None or t <= cap):
            last_logits, cache, pos = prefill(params, cfg, prompt, max_len)
        else:
            last_logits, cache, pos = chunked_prefill(params, cfg, prompt, max_len,
                                                      chunk=prefill_chunk)
        new_tokens, _ = _decode_loop(params, cfg, cache, last_logits, gen, pos, key)
    return torch.cat([prompt.to(torch.int32), new_tokens], dim=1)
