"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B] (port of
``repro.configs.qwen2_moe_a2_7b``).

24L d_model=2048 16H (GQA kv=16) vocab=151936; MoE: 60 routed experts top-4
(per-expert d_ff=1408) + 4 shared experts (shared intermediate 5632).
"""
import torch

from repro_torch.configs.base import ArchSpec, SKIP_LONG, register
from repro_torch.models.transformer import ModelConfig
from repro_torch.nn.moe import MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=151936, d_head=128,
        moe=MoEConfig(n_experts=60, top_k=4, d_ff=1408,
                      n_shared_experts=4, shared_d_ff=5632,
                      capacity_factor=1.25, group_size=4096),
        mlp_kind="swiglu", norm="rmsnorm", pos="rope", rope_theta=1_000_000.0,
        tie_embeddings=False,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab_size=128, d_head=16,
        moe=MoEConfig(n_experts=6, top_k=2, d_ff=32, n_shared_experts=2,
                      shared_d_ff=48, capacity_factor=2.0, group_size=64,
                      exec_mode="dense"),
        mlp_kind="swiglu", norm="rmsnorm", pos="rope",
        tie_embeddings=False, scan_layers=False, remat=False,
    )


register(ArchSpec(
    arch_id="qwen2-moe-a2.7b", family="moe", full=full, smoke=smoke,
    skip_shapes=(SKIP_LONG,),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
