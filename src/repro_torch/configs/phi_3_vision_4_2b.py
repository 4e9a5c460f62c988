"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064. phi3-mini text
backbone + CLIP vision frontend. Per assignment the modality frontend is a
STUB: ``input_specs`` supplies precomputed patch embeddings (576 = 24x24
CLIP-style patches at d_model) as a prefix to the token sequence.

Port of ``repro.configs.phi_3_vision_4_2b``: the same fields, ``skip_shapes`` and
``source``.
"""
import torch

from repro_torch.configs.base import ArchSpec, SKIP_LONG, register
from repro_torch.models.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064, d_head=96,
        mlp_kind="swiglu", norm="rmsnorm", pos="rope", rope_theta=10000.0,
        input_kind="mixed", n_prefix_embeds=576,
        tie_embeddings=False,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3v-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=128, d_head=16,
        mlp_kind="swiglu", norm="rmsnorm", pos="rope",
        input_kind="mixed", n_prefix_embeds=8,
        tie_embeddings=False, scan_layers=False, remat=False,
    )


register(ArchSpec(
    arch_id="phi-3-vision-4.2b", family="vlm", full=full, smoke=smoke,
    skip_shapes=(SKIP_LONG,),
    source="hf:microsoft/Phi-3-vision-128k-instruct",
))
