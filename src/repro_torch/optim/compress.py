"""INT8 gradient compression with error feedback (port of
``repro.optim.compress``).

Scheme (1-bit-Adam-style generalized to int8):
  1. g_corrected = g + error_residual
  2. per-tensor symmetric int8 quantize -> what would cross the slow
     data-parallel link: 4x fewer bytes than f32
  3. error_residual' = g_corrected - dequant(q)

What int8 drops is carried to the next step, never lost: emitted +
residual equals the sum of the inputs. The scale divides by a tensor on
the gradient's device, so CUDA divides as the reference does.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.nn.module import Params, flatten_params, tree_map, tree_map_with_path


class ErrorFeedbackState(NamedTuple):
    residual: Params


def ef_init(params: Params) -> ErrorFeedbackState:
    return ErrorFeedbackState(
        residual=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def _q_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax / torch.full((), 127.0, device=x.device), min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads: Params, ef: ErrorFeedbackState
                   ) -> Tuple[Params, ErrorFeedbackState]:
    """Returns (int8-representable grads as f32, new error state)."""
    residual = dict(flatten_params(ef.residual))
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for path, g in flatten_params(grads):
        g32 = g.float() + residual[path]
        q, s = _q_int8(g32)
        deq = q.float() * s
        out[path] = (deq, g32 - deq)
    return (tree_map_with_path(lambda path, _: out[path][0], grads),
            ErrorFeedbackState(tree_map_with_path(lambda path, _: out[path][1], grads)))
