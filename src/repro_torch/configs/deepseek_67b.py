"""deepseek-67b [arXiv:2401.02954] — llama-architecture dense model.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.

Port of ``repro.configs.deepseek_67b``: the same fields, ``skip_shapes`` and
``source``.
"""
import torch

from repro_torch.configs.base import ArchSpec, SKIP_LONG, register
from repro_torch.models.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab_size=102400, d_head=128,
        mlp_kind="swiglu", norm="rmsnorm", pos="rope", rope_theta=10000.0,
        tie_embeddings=False,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=160, vocab_size=128, d_head=8,
        mlp_kind="swiglu", norm="rmsnorm", pos="rope",
        tie_embeddings=False, scan_layers=False, remat=False,
    )


register(ArchSpec(
    arch_id="deepseek-67b", family="dense", full=full, smoke=smoke,
    skip_shapes=(SKIP_LONG,),
    source="arXiv:2401.02954",
))
