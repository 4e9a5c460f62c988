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

__all__ = [
    "DTypePolicy", "cast_tree", "flatten_params", "param_bytes",
    "param_count", "split_keys", "tree_slice", "tree_stack",
]
