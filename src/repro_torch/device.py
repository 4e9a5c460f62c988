"""Device selection for the port's entry points."""
from __future__ import annotations

import functools
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Asking for CUDA on a machine without a GPU raises —
    the CPU is never chosen on the caller's behalf."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` lies on (the
    kernels' static plans take it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
