"""Deterministic synthetic language-modeling data (port of
``repro.data.synthetic``: the same numpy generator, so the same seed and
index give the same batch, bit for bit).

A fixed (seeded) Zipf-weighted first-order Markov chain over the vocabulary
generates token streams with learnable structure — perplexity drops well
below uniform as a model trains, which is what the paper-protocol
benchmarks need (outlier growth appears when the model actually learns).

The pipeline is host-sharded and stateless-resumable: batch ``i`` is a pure
function of (seed, i), so fault-tolerant restarts just set the step counter
(no data-state checkpoint needed) and elastic re-runs stay deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    batch_size: int               # per-host batch
    seed: int = 0
    branching: int = 32           # out-degree of the Markov chain
    mask_prob: float = 0.15       # for MLM batches
    mask_token: int = 1
    n_special: int = 4            # reserved low token-ids


class SyntheticLM:
    def __init__(self, cfg: SyntheticLMConfig) -> None:
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, b = cfg.vocab_size, min(cfg.branching, cfg.vocab_size - cfg.n_special)
        # per-state successor sets + Zipf transition probabilities
        self._succ = rng.integers(cfg.n_special, v, size=(v, b), dtype=np.int64)
        p = 1.0 / np.arange(1, b + 1) ** 1.1
        self._p = p / p.sum()

    # -- core generator ----------------------------------------------------
    def _gen_tokens(self, rng: np.random.Generator, n_rows: int) -> np.ndarray:
        cfg = self.cfg
        toks = np.empty((n_rows, cfg.seq_len), dtype=np.int32)
        state = rng.integers(cfg.n_special, cfg.vocab_size, size=n_rows)
        choices = rng.choice(len(self._p), p=self._p,
                             size=(n_rows, cfg.seq_len))
        for t in range(cfg.seq_len):
            state = self._succ[state, choices[:, t]]
            toks[:, t] = state
        return toks

    def batch(self, index: int, kind: str = "clm") -> Dict[str, np.ndarray]:
        """Pure function of (seed, index). kinds: clm | mlm | frames."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        toks = self._gen_tokens(rng, cfg.batch_size)
        if kind == "clm":
            return {"tokens": toks, "labels": toks.copy()}
        if kind == "mlm":
            labels = np.full_like(toks, -100)
            mask = rng.random(toks.shape) < cfg.mask_prob
            labels[mask] = toks[mask]
            masked = toks.copy()
            # 80/10/10 masking like BERT
            r = rng.random(toks.shape)
            masked[mask & (r < 0.8)] = cfg.mask_token
            rand_tok = rng.integers(cfg.n_special, cfg.vocab_size, toks.shape)
            masked[mask & (r >= 0.9)] = rand_tok[mask & (r >= 0.9)]
            return {"tokens": masked, "labels": labels}
        if kind == "frames":
            # audio-style: continuous frame embeddings + cluster targets
            d = 24
            emb = rng.standard_normal((cfg.batch_size, cfg.seq_len, d)).astype(np.float32)
            return {"embeds": emb, "labels": toks % cfg.vocab_size}
        raise ValueError(kind)

    def iterate(self, kind: str = "clm", start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        i = start
        while True:
            yield self.batch(i, kind)
            i += 1
