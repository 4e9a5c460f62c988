"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base] (port of
``repro.configs.granite_moe_1b_a400m``).

24L d_model=1024 16H (GQA kv=8) vocab=49155; MoE: 32 experts, top-8,
per-expert d_ff=512.
"""
import torch

from repro_torch.configs.base import ArchSpec, SKIP_LONG, register
from repro_torch.models.transformer import ModelConfig
from repro_torch.nn.moe import MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab_size=49155, d_head=64,
        pattern=("attn",),
        moe=MoEConfig(n_experts=32, top_k=8, d_ff=512,
                      capacity_factor=1.25, group_size=4096),
        mlp_kind="swiglu", norm="rmsnorm", pos="rope", rope_theta=10000.0,
        tie_embeddings=True,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab_size=128, d_head=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=32, capacity_factor=2.0,
                      group_size=64, exec_mode="dense"),
        mlp_kind="swiglu", norm="rmsnorm", pos="rope",
        scan_layers=False, remat=False,
    )


register(ArchSpec(
    arch_id="granite-moe-1b-a400m", family="moe", full=full, smoke=smoke,
    skip_shapes=(SKIP_LONG,),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
