"""Loss functions (port of ``repro.train.losses``): causal LM (shifted),
masked LM (ignore_index=-100), frame classification. All return
(sum_nll f32, n_tokens f32) so callers can aggregate exact perplexities
across batches."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed.sharding import maybe_constrain

IGNORE = -100


def _nll(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0).long()[..., None])
    # under a mesh, a vocab-sharded gather is a masked partial sum: reduce
    # it while it still has the index's shape (DTensor masks by that shape)
    gold = maybe_constrain(gold, "dp", None, None)[..., 0]
    nll = (logz - gold) * valid
    return nll.sum(), valid.sum()


def clm_loss(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal LM: predict token t+1 from logits at t."""
    lg = logits[:, :-1, :]
    lb = labels[:, 1:]
    valid = (lb != IGNORE).float()
    return _nll(lg, lb, valid)


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked LM: labels are -100 except at masked positions."""
    valid = (labels != IGNORE).float()
    return _nll(logits, labels, valid)


def frame_loss(logits: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame classification over all positions (hubert-style)."""
    valid = (labels != IGNORE).float()
    return _nll(logits, labels, valid)


def loss_for(kind: str):
    return {"clm": clm_loss, "mlm": mlm_loss, "frames": frame_loss}[kind]
