"""recurrentgemma-9b [arXiv:2402.19427] — Griffin hybrid (port of
``repro.configs.recurrentgemma_9b``).

38L d_model=4096, 16H local attention (MQA kv=1, window 2048), RG-LRU
recurrent blocks at 2:1 ratio: pattern (griffin, griffin, local_attn) x 12
groups + 2 trailing griffin blocks = 38 layers. d_ff=12288, vocab=256000.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer import ModelConfig
from repro_torch.nn.recurrent import RGLRUConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab_size=256000, d_head=256,
        pattern=("griffin", "griffin", "local_attn"), window=2048,
        rglru=RGLRUConfig(width=4096, conv_width=4),
        embed_scale=True,
        mlp_kind="geglu", norm="rmsnorm", pos="rope", rope_theta=10000.0,
        tie_embeddings=True,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab_size=128, d_head=16,
        pattern=("griffin", "griffin", "local_attn"), window=8,
        rglru=RGLRUConfig(width=64, conv_width=4),
        embed_scale=True,
        mlp_kind="geglu", norm="rmsnorm", pos="rope",
        scan_layers=False, remat=False,
    )


register(ArchSpec(
    arch_id="recurrentgemma-9b", family="hybrid", full=full, smoke=smoke,
    skip_shapes=(),              # sub-quadratic: runs long_500k
    source="arXiv:2402.19427",
))
