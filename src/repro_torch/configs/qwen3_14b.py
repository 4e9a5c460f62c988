"""qwen3-14b [hf:Qwen/Qwen3-8B family] (port of ``repro.configs.qwen3_14b``).

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, qk-norm.
"""
import torch

from repro_torch.models.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab_size=151936, d_head=128,
        qk_norm=True,
        mlp_kind="swiglu", norm="rmsnorm", pos="rope", rope_theta=1_000_000.0,
        tie_embeddings=False,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab_size=128, d_head=8, qk_norm=True,
        mlp_kind="swiglu", norm="rmsnorm", pos="rope",
        tie_embeddings=False, scan_layers=False, remat=False,
    )
