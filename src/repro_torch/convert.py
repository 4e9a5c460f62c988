"""Reference weights into the port: ``from_jax_params``.

Turns a ``repro.models.model_init`` params tree, handed over as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), into the port's
nested dicts of tensors. The two packages share one layout, so this is a
leaf-wise conversion that keeps the structure: the scanned ``groups``
stack (leading layer-group axis) stays stacked, the unrolled ``layers``
list stays a list, an unrolled ``tail`` stays a dict, and Griffin's
leaves, the xLSTM blocks' (the (H, dh, dh) sLSTM recurrences, the
head-wise norm scales, the gate biases) and ``w_q8``/``w_scale`` convert
like any other. Every leaf keeps
its dtype (Griffin's ``lambda`` stays f32 in a bf16 model). bfloat16 leaves arrive as ml_dtypes arrays numpy cannot hand to
torch directly; they go through float32, which holds them exactly.
An int8 leaf of two or more axes (the codes ``w_q8``, the only int8
leaves a params tree holds) keeps its shape and values and is stored
K-major, through ``kernels.int8_matmul.empty_k_major`` as every maker of
the codes stores them: the layout the int8 kernel reads.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.int8_matmul import empty_k_major
from repro_torch.models.transformer import ModelConfig, check_supported
from repro_torch.nn.module import tree_map


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    if t.dtype == torch.int8 and t.dim() >= 2:
        return empty_k_major(t.shape, device).copy_(t)
    return t.to(device)


def from_jax_params(tree: Any, cfg: ModelConfig, device="cuda") -> Any:
    """Numpy params tree of the JAX package -> the port's params on
    ``device``. ``cfg`` must be the config the tree was built for: a
    scanned config needs the ``groups`` stack, an unrolled one the
    ``layers`` list."""
    check_supported(cfg)
    dev = resolve_device(device)
    scanned = cfg.scan_layers and cfg.n_groups > 0
    if scanned != ("groups" in tree):
        raise ValueError(
            f"params layout {'groups' if 'groups' in tree else 'layers'} does "
            f"not match cfg.scan_layers={cfg.scan_layers}")
    return tree_map(lambda x: _leaf(x, dev), tree)
