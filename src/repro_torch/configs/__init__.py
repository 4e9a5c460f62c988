"""Architecture config registry (port of ``repro.configs``): the ported
archs and the paper's own models."""
from repro_torch.configs.base import (
    SHAPES,
    ArchSpec,
    ShapeSpec,
    apply_method,
    cache_specs,
    get_arch,
    input_specs,
    list_archs,
    to_bf16,
)

__all__ = [
    "SHAPES", "ArchSpec", "ShapeSpec", "apply_method", "cache_specs",
    "get_arch", "input_specs", "list_archs", "to_bf16",
]
