from repro_torch.models.transformer import (
    ModelConfig,
    copy_pool_blocks,
    init_cache,
    init_paged_cache,
    model_apply,
    model_init,
    paged_kv_block_bytes,
)

__all__ = ["ModelConfig", "copy_pool_blocks", "init_cache", "init_paged_cache",
           "model_apply", "model_init", "paged_kv_block_bytes"]
