"""gemma2-27b [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, alternating
local (window 4096) / global attention, logit soft-capping (attn 50,
final 30), sandwich (pre+post) RMSNorms, GeGLU, scaled embeddings.

Port of ``repro.configs.gemma2_27b``: the same fields, ``skip_shapes`` and
``source``.
"""
import torch

from repro_torch.configs.base import ArchSpec, SKIP_LONG, register
from repro_torch.models.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
        d_ff=36864, vocab_size=256000, d_head=128,
        pattern=("local_attn", "attn"), window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_block_norm=True, embed_scale=True,
        mlp_kind="geglu", norm="rmsnorm", pos="rope", rope_theta=10000.0,
        tie_embeddings=True,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        n_layers=4, d_model=48, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=128, d_head=16,   # d_head*H != d_model, like real
        pattern=("local_attn", "attn"), window=8,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_block_norm=True, embed_scale=True,
        mlp_kind="geglu", norm="rmsnorm", pos="rope",
        scan_layers=False, remat=False,
    )


register(ArchSpec(
    arch_id="gemma2-27b", family="dense", full=full, smoke=smoke,
    skip_shapes=(SKIP_LONG,),   # global layers are still quadratic
    source="arXiv:2408.00118",
))
