"""Mesh construction over torch ``DeviceMesh`` (port of
``repro.launch.mesh``).

Functions, never module-level constants: importing this module touches
no process group. A ``DeviceMesh`` needs a default process group of its
size, and a process has one default group:

  * ``make_production_mesh`` builds the 16x16 (256 chips) or 2x16x16
    (512 chips) mesh. With no default group it starts torch's ``fake``
    backend at that world size (this process is rank 0 and every
    collective is a no-op): a mesh to lay out and count a step on, as the
    reference's dry-run lays one out over 512 forced host devices. So
    the dry-run runs in a process of its own.
  * ``make_host_mesh`` builds (1, n) over the ranks of a real group: with
    no default group, a one-rank group from an in-process store (no
    network), so n = 1 — one process drives one card.

``close_mesh`` destroys the default group (tests set a mesh up and tear
it down in a module fixture).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def _init_fake(world_size: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _mesh(device_type: str, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """16x16 = 256-chip single pod, or 2x16x16 = 512-chip two-pod mesh.

    Axis order puts 'pod' outermost (slowest links), then 'data'
    (intra-pod DP/FSDP), then 'model' (TP/EP, fastest neighbours), as in
    the reference. Starts the ``fake`` backend at the mesh's size when no
    default group exists; raises when one of another size does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        _init_fake(n)
    elif dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs a default group of {n} ranks; this "
                           f"process has one of {dist.get_world_size()} (one group a "
                           f"process: run the dry-run in a process of its own)")
    return _mesh(device_type, shape, axes)


def make_host_mesh(device="cuda"):
    """(1, n) over the default group's ranks; with no default group, a
    one-rank group (``nccl`` on the card, ``gloo`` on the CPU) over an
    in-process store, so (1, 1)."""
    dev = torch.device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return _mesh(dev.type, (1, dist.get_world_size()), ("data", "model"))


def mesh_size(mesh) -> int:
    return int(mesh.mesh.numel())


def close_mesh() -> None:
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
