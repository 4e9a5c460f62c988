"""The functional module system (port of ``repro.nn``)."""
from repro_torch.nn.module import (
    DTypePolicy,
    cast_tree,
    flatten_params,
    param_bytes,
    param_count,
    split_keys,
    tree_slice,
    tree_stack,
)
from repro_torch.nn.moe import MoEConfig, dropped_claims, moe_apply, moe_init

__all__ = [
    "DTypePolicy", "MoEConfig", "cast_tree", "dropped_claims", "flatten_params",
    "moe_apply", "moe_init", "param_bytes", "param_count", "split_keys",
    "tree_slice", "tree_stack",
]
