from repro_torch.serving.decode import (
    GenerateConfig,
    chunked_prefill,
    decode_one,
    generate,
    make_mixed_step,
    make_spec_step,
    prefill,
    sample_logits,
    sample_logits_one_key,
    sample_rows,
    sample_rows_all,
    sample_token_at,
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
           "Request", "SpecConfig", "SwappedState", "chunked_prefill",
           "decode_one", "generate", "make_mixed_step", "make_spec_step",
           "prefill", "sample_logits", "sample_logits_one_key", "sample_rows",
           "sample_rows_all", "sample_token_at", "step_rows", "step_rows_full"]
