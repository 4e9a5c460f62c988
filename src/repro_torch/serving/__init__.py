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
from repro_torch.serving.workload import (
    DEFAULT_TIERS,
    TickCostModel,
    TierSpec,
    TraceEntry,
    WorkloadConfig,
    WorkloadReport,
    generate_trace,
    run_workload,
)
from repro_torch.serving.chaos import ChaosHarness, FaultPlan, FaultyAllocator

__all__ = ["AllocatorAuditError", "BlockAllocator", "ChaosHarness",
           "ContinuousBatcher", "DEFAULT_TIERS", "FaultPlan", "FaultyAllocator",
           "GenerateConfig", "NGramDrafter", "PrefillState", "PrefixCache",
           "Request", "SpecConfig", "SwappedState", "TickCostModel", "TierSpec",
           "TraceEntry", "WorkloadConfig", "WorkloadReport", "chunked_prefill",
           "decode_one", "generate", "generate_trace", "make_mixed_step",
           "make_spec_step", "prefill", "run_workload", "sample_logits",
           "sample_logits_one_key", "sample_rows", "sample_rows_all",
           "sample_token_at", "step_rows", "step_rows_full"]
