"""Sharding rules over a torch ``DeviceMesh`` (port of
``repro.distributed``)."""
from repro_torch.distributed.sharding import (
    batch_specs,
    cache_specs_tree,
    maybe_constrain,
    param_rules,
    spec_for_path,
    tree_param_specs,
    tree_placements,
    use_mesh,
)

__all__ = [
    "batch_specs", "cache_specs_tree", "maybe_constrain", "param_rules",
    "spec_for_path", "tree_param_specs", "tree_placements", "use_mesh",
]
