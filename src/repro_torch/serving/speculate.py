"""Model-free speculative drafting for the continuous batcher (a copy of
``repro.serving.speculate``, pure numpy).

Speculative decoding splits token generation into a cheap *drafter* that
guesses the next ``k`` tokens and the real model *verifying* all ``k``
guesses in one forward pass. The drafter here is the model-free n-gram /
prompt-lookup scheme (Saxena's prompt-lookup decoding, the assisted-
generation variant HF ships): the last ``n`` tokens of a row's own
prompt+output history are searched for an earlier occurrence, and the
tokens that followed that occurrence become the draft. No draft model,
no extra memory, no training — it exploits the empirical fact that
generation (summaries, code, chat with quoting, anything repetitive)
re-uses long spans of its own context.

Why verification is *lossless* here (not merely "close"): the engine's
sampling rule is position-keyed — the token at logical position ``p`` is
drawn from a counter-based draw keyed by (request seed, p)
(greedy is the temperature-0 special case). Sampling is therefore a pure
function of (request seed, position, logits), and the verifying forward
computes exactly the logits plain decoding would have seen at every
draft position (same weights, same quantized cache, same attention
read). A draft token is accepted iff it EQUALS the verifier's sample at
its position, so the emitted stream is bitwise identical to the
non-speculative engine — fp and int8, greedy and sampled. The draft
quality only moves throughput, never content.

The scheduler-side integration (multi-block allocation for ``k+1``
writes per tick, rejected-write hygiene, accounting) lives in
``repro_torch.serving.scheduler``; the verifying tick is
``repro_torch.serving.decode.make_spec_step``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Knobs for ``ContinuousBatcher(..., spec=SpecConfig(...))``.

    ``k``: max draft tokens proposed per decode row per tick — a row
    advances by 1..k+1 tokens per tick (the +1 is the verifier's own
    "bonus" sample at the first rejected/exhausted position, so a tick
    with speculation NEVER yields fewer tokens than one without).
    ``max_ngram``/``min_ngram``: suffix lengths tried by the drafter,
    longest first — longer matches are rarer but much more predictive.
    ``min_context``: don't bother drafting before this many tokens of
    history exist (a 2-token context has nothing to look up)."""
    k: int = 4
    max_ngram: int = 3
    min_ngram: int = 1
    min_context: int = 4

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={self.min_ngram} max_ngram={self.max_ngram}")
        if self.min_context < 1:
            raise ValueError("SpecConfig.min_context must be >= 1")


class NGramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most
    recent earlier occurrence of the context's own suffix.

    Host-side and stateless across calls — the "draft model" is the
    row's context itself, so there is nothing to train, snapshot, swap
    or invalidate on preemption. O(max_ngram * len(context)) numpy per
    call, negligible next to the tick's forward."""

    def __init__(self, spec: SpecConfig) -> None:
        self.spec = spec

    def propose(self, prompt: np.ndarray, generated: Sequence[int],
                k: int) -> List[int]:
        """Up to ``k`` draft tokens for a row whose history is
        ``prompt + generated``. Empty list = no match (the tick then
        degrades to a plain 1-token decode for this row)."""
        spec = self.spec
        ctx = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(generated, np.int64)])
        n_ctx = len(ctx)
        if k <= 0 or n_ctx < spec.min_context:
            return []
        for n in range(min(spec.max_ngram, n_ctx - 1),
                       spec.min_ngram - 1, -1):
            pat = ctx[n_ctx - n:]
            # candidate starts: first-token matches strictly before the
            # suffix itself (a window may overlap INTO the suffix — the
            # continuation it predicts is still real history)
            starts = np.flatnonzero(ctx[:n_ctx - n] == pat[0])
            for i in starts[::-1]:                 # most recent first
                if np.array_equal(ctx[i:i + n], pat):
                    cont = ctx[i + n:i + n + k]
                    return [int(t) for t in cont]
        return []
