from repro_torch.configs import qwen3_14b, recurrentgemma_9b
from repro_torch.configs.base import apply_method

__all__ = ["apply_method", "qwen3_14b", "recurrentgemma_9b"]
