"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module paths and function names, so each
module's counterpart is found under the same path. It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro`` — and keeps its
own copies of what it needs.

Entry points (``models.model_init``, ``models.init_paged_cache``,
``serving.ContinuousBatcher``) take ``device=`` and default to
``"cuda"``; the CPU is used only when the caller asks for it, and
``resolve_device`` raises when a CUDA device is asked for and none is
present.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
