"""hubert-xlarge [arXiv:2106.07447] — encoder-only audio transformer.

48L d_model=1280 16H (MHA kv=16) d_ff=5120, 504 cluster-classification
targets. The wav2vec2-style conv feature extractor is a STUB per the
assignment: ``input_specs`` provides precomputed 512-d frame embeddings;
the model projects 512 -> 1280 and runs the BERT-like encoder.

Encoder-only: no autoregressive step, so decode_32k / long_500k are skipped
(documented); prefill_32k is a 32768-frame encoder forward pass.

Port of ``repro.configs.hubert_xlarge``: the same fields, ``skip_shapes`` and
``source``.
"""
import torch

from repro_torch.configs.base import ArchSpec, SKIP_DECODE_ENC, SKIP_LONG_ENC, register
from repro_torch.models.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab_size=504, d_head=80,
        causal=False,
        mlp_kind="gelu", norm="layernorm", norm_position="pre",
        pos="learned", max_seq_len=65536,
        input_kind="embeds", frontend_dim=512,
        tie_embeddings=False,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=32, d_head=16,
        causal=False,
        mlp_kind="gelu", norm="layernorm", pos="learned", max_seq_len=256,
        input_kind="embeds", frontend_dim=24,
        tie_embeddings=False, scan_layers=False, remat=False,
    )


register(ArchSpec(
    arch_id="hubert-xlarge", family="audio", full=full, smoke=smoke,
    skip_shapes=(SKIP_DECODE_ENC, SKIP_LONG_ENC),
    source="arXiv:2106.07447",
))
