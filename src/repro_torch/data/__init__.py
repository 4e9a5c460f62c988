"""Synthetic data (port of ``repro.data``)."""
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig

__all__ = ["SyntheticLM", "SyntheticLMConfig"]
