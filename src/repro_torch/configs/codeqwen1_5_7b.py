"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 architecture.

32L d_model=4096 32H (MHA kv=32) d_ff=13440 vocab=92416.

Port of ``repro.configs.codeqwen1_5_7b``: the same fields, ``skip_shapes`` and
``source``.
"""
import torch

from repro_torch.configs.base import ArchSpec, SKIP_LONG, register
from repro_torch.models.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab_size=92416, d_head=128,
        mlp_kind="swiglu", norm="rmsnorm", pos="rope", rope_theta=1_000_000.0,
        tie_embeddings=False,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="codeqwen-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=128, d_head=16,
        mlp_kind="swiglu", norm="rmsnorm", pos="rope",
        tie_embeddings=False, scan_layers=False, remat=False,
    )


register(ArchSpec(
    arch_id="codeqwen1.5-7b", family="dense", full=full, smoke=smoke,
    skip_shapes=(SKIP_LONG,),
    source="hf:Qwen/CodeQwen1.5-7B",
))
