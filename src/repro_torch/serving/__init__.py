from repro_torch.serving.decode import (
    GenerateConfig,
    make_mixed_step,
    make_spec_step,
    sample_logits,
    sample_rows,
    sample_rows_all,
    step_rows,
    step_rows_full,
)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import (
    AllocatorAuditError,
    BlockAllocator,
    ContinuousBatcher,
    PrefillState,
    Request,
    SwappedState,
)
from repro_torch.serving.speculate import NGramDrafter, SpecConfig

__all__ = ["AllocatorAuditError", "BlockAllocator", "ContinuousBatcher",
           "GenerateConfig", "NGramDrafter", "PrefillState", "PrefixCache",
           "Request", "SpecConfig", "SwappedState", "make_mixed_step",
           "make_spec_step", "sample_logits", "sample_rows",
           "sample_rows_all", "step_rows", "step_rows_full"]
