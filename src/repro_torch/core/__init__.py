"""Paper core: clipped softmax, gated attention, outlier telemetry (port
of ``repro.core``, with the same exports)."""
from repro_torch.core.softmax import (
    ClippedSoftmaxConfig,
    clipped_softmax,
    clipped_softmax_from_config,
    softcap,
    softmax,
    stretch_and_clip,
)
from repro_torch.core.gating import (
    GateConfig,
    gate_logits,
    gate_param_count,
    gate_probs,
    init_gate,
)
from repro_torch.core.attention import (
    AttentionConfig,
    attention,
    chunked_attention,
    dense_attention,
    make_attention_mask,
    paged_attention,
)
from repro_torch.core.outliers import (
    OutlierStats,
    collect_activation_stats,
    infinity_norm,
    kurtosis,
    outlier_counts_by_dim,
    outlier_counts_by_token,
    outlier_mask,
)

__all__ = [
    "ClippedSoftmaxConfig", "clipped_softmax", "clipped_softmax_from_config",
    "softcap", "softmax", "stretch_and_clip",
    "GateConfig", "gate_logits", "gate_param_count", "gate_probs", "init_gate",
    "AttentionConfig", "attention", "chunked_attention", "dense_attention",
    "make_attention_mask", "paged_attention",
    "OutlierStats", "collect_activation_stats", "infinity_norm", "kurtosis",
    "outlier_counts_by_dim", "outlier_counts_by_token", "outlier_mask",
]
