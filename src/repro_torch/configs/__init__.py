from repro_torch.configs import paper_models, qwen3_14b, recurrentgemma_9b
from repro_torch.configs.base import apply_method

__all__ = ["apply_method", "paper_models", "qwen3_14b", "recurrentgemma_9b"]
