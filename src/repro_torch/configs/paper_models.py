"""The paper's own models: BERT-base, BERT-6L, OPT-125m, ViT-S/16-style
(port of ``repro.configs.paper_models``).

The reduced ``*_tiny`` variants run the same protocol at CPU scale (same
family: post-LN MLM encoder for BERT, pre-LN CLM decoder for OPT). Params
and compute are f32, as in the reference. ``vit_s16`` is an encoder over
197 patch embeddings (``input_kind="embeds"``, through a 384 -> 384
``frontend_proj``) with a 1000-way head.
"""
from repro_torch.models.transformer import ModelConfig


def bert_base() -> ModelConfig:
    return ModelConfig(
        name="bert-base", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=30522, d_head=64,
        causal=False, norm="layernorm", norm_position="post",
        mlp_kind="gelu", pos="learned", max_seq_len=512,
        tie_embeddings=True, scan_layers=False, remat=False,
    )


def bert_6l(seq_len: int = 128) -> ModelConfig:
    return ModelConfig(
        name="bert-6l", n_layers=6, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=30522, d_head=64,
        causal=False, norm="layernorm", norm_position="post",
        mlp_kind="gelu", pos="learned", max_seq_len=max(seq_len, 512),
        tie_embeddings=True, scan_layers=False, remat=False,
    )


def bert_tiny(vocab: int = 2048, seq_len: int = 128) -> ModelConfig:
    """Reduced BERT family for CPU-scale paper-protocol runs."""
    return ModelConfig(
        name="bert-tiny", n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=vocab, d_head=32,
        causal=False, norm="layernorm", norm_position="post",
        mlp_kind="gelu", pos="learned", max_seq_len=max(seq_len, 128),
        tie_embeddings=True, scan_layers=False, remat=False,
    )


def opt_125m() -> ModelConfig:
    return ModelConfig(
        name="opt-125m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=50272, d_head=64,
        causal=True, norm="layernorm", norm_position="pre",
        mlp_kind="relu", pos="learned", max_seq_len=2048,
        tie_embeddings=True, scan_layers=False, remat=False,
        init_std=0.006,
    )


def opt_tiny(vocab: int = 2048, seq_len: int = 256) -> ModelConfig:
    return ModelConfig(
        name="opt-tiny", n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=vocab, d_head=32,
        causal=True, norm="layernorm", norm_position="pre",
        mlp_kind="relu", pos="learned", max_seq_len=max(seq_len, 256),
        tie_embeddings=True, scan_layers=False, remat=False,
        init_std=0.006,
    )


def vit_s16() -> ModelConfig:
    """ViT-S/16 as an encoder over 197 patch embeddings (frontend stubbed;
    classification head = 1000-way 'vocab'). Not run by the port yet
    (``input_kind="embeds"``)."""
    return ModelConfig(
        name="vit-s16", n_layers=12, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab_size=1000, d_head=64,
        causal=False, norm="layernorm", norm_position="pre",
        mlp_kind="gelu", pos="learned", max_seq_len=256,
        input_kind="embeds", frontend_dim=384,
        tie_embeddings=False, scan_layers=False, remat=False,
    )
