"""Hardware-path W8A8 serving: int8 weights beside the fp ones, and
linears through the integer kernel (port of ``repro.quant.int8_weights``).

Weights are stored as int8 with a per-tensor f32 scale, with the
reference's (K, N) shape and values, K-major in memory (the layout the
kernel reads; see ``kernels.int8_matmul``); activations are quantized by
the kernel's pre-pass; products run int8 x int8 -> int32. Trees keep the
reference's leaves: the fp ``w`` stays beside ``w_q8``/``w_scale``, and
the pattern below also attaches a pair to the attention gate's 2-D
``.../gate/w``, which the gate never reads.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.int8_matmul import (empty_k_major, int8_matmul,
                                             quantize_weights_int8)
from repro_torch.nn.module import flatten_params

# param paths worth int8-caching: the big matmul weights
_MATMUL_W = re.compile(
    r".*/(q|k|v|o|up|gate|down|in_x|in_gate|out|w_a|w_x|zifo|ff_up|ff_gate|"
    r"ff_down)/w$|.*lm_head/w$|.*embed/table$")


def build_int8_cache(params: Any, skip: Tuple[str, ...] = (r".*lm_head.*",)
                     ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Quantize every 2-D matmul weight to (int8 tensor, f32 scale), keyed
    by param path."""
    cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for path, leaf in flatten_params(params):
        if leaf.ndim != 2 or not _MATMUL_W.match(path):
            continue
        if any(re.match(p, path) for p in skip):
            continue
        cache[path] = quantize_weights_int8(leaf)
    return cache


def int8_cache_bytes(cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]]) -> int:
    return sum(int(wq.numel()) for wq, _ in cache.values())


def _quantize_stacked(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer scales for a stacked (G, K, N) weight, as the reference's
    ``vmap``; one layer at a time, so the f32 temporaries stay one layer's
    size. The codes are stored K-major like ``quantize_weights_int8``'s, so
    ``tree_slice`` carves K-major (K, N) layers."""
    wq = empty_k_major(w.shape, w.device)
    scale = torch.empty((w.shape[0],), dtype=torch.float32, device=w.device)
    for g in range(w.shape[0]):
        wq[g], scale[g] = quantize_weights_int8(w[g])
    return wq, scale


def attach_int8_weights(params: Any, skip: Tuple[str, ...] = (r".*lm_head.*",)
                        ) -> Any:
    """A params tree with ``w_q8``/``w_scale`` leaves attached beside every
    matmul weight ``w`` (the other leaves are the same tensors).

    Attaching to the tree rather than to a table keyed by site name keeps
    every layer's own weights: site names repeat across layer groups,
    params paths do not. A stacked ``(G, K, N)`` weight gets a stacked
    int8 leaf and ``(G,)`` per-layer scales, which ``tree_slice`` carves
    per layer beside the fp weight."""
    def walk(node: Any, prefix: str) -> Any:
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, f"{prefix}/{k}" if prefix else k)
               for k, v in node.items()}
        w = node.get("w")
        wpath = f"{prefix}/w" if prefix else "w"
        if (isinstance(w, torch.Tensor) and w.ndim in (2, 3)
                and _MATMUL_W.match(wpath)
                and not any(re.match(p, wpath) for p in skip)):
            wq, s = quantize_weights_int8(w) if w.ndim == 2 else _quantize_stacked(w)
            out["w_q8"], out["w_scale"] = wq, s
        return out

    return walk(params, "")


def linear_int8(cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]], path: str,
                x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run one cached linear through the integer kernel."""
    wq, s = cache[path]
    lead = x.shape[:-1]
    y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), wq, s)
    y = y.reshape(*lead, wq.shape[1])
    if bias is not None:
        y = y + bias
    return y
