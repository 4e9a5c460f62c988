"""xlstm-1.3b [arXiv:2405.04517] (port of ``repro.configs.xlstm_1_3b``).

48 blocks, d_model=2048, 4 heads, d_ff=0 (the m/sLSTM blocks carry their
own projections), vocab=50304 (gpt-neox tokenizer). Block ratio 7:1
mLSTM:sLSTM. Recurrent, so it runs the long_500k cell.

The paper's clipped softmax and gated attention do not apply (no softmax
over tokens); the cells' output gates already give the explicit no-op
path.
"""
import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer import ModelConfig
from repro_torch.nn.xlstm import XLSTMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304, d_head=512,
        pattern=("mlstm",) * 7 + ("slstm",),
        xlstm=XLSTMConfig(d_model=2048, n_heads=4, chunk_size=128),
        mlp_kind="none", norm="layernorm", pos="none",
        tie_embeddings=True,
        vocab_pad_to=128,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        n_layers=4, d_model=32, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=128, d_head=8,
        pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        xlstm=XLSTMConfig(d_model=32, n_heads=4, chunk_size=8),
        mlp_kind="none", norm="layernorm", pos="none",
        scan_layers=False, remat=False,
    )


register(ArchSpec(
    arch_id="xlstm-1.3b", family="ssm", full=full, smoke=smoke,
    skip_shapes=(),              # recurrent: runs long_500k
    source="arXiv:2405.04517",
))
