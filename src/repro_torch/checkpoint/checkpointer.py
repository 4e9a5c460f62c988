"""Fault-tolerant checkpointing (port of
``repro.checkpoint.checkpointer``), in the reference's on-disk format, so
a checkpoint written by either package restores into the other:

  * ``step_XXXXXXXX/`` holding ``manifest.json`` (step; each leaf's
    '/'-joined path, shape and dtype) and ``arrays.npz`` (one array per
    leaf, keyed by its path with '/' -> '.');
  * **atomic commit** — written to ``step_XXXXXXXX.tmp/``, fsync'd, then
    renamed, so a crash mid-save never corrupts the latest checkpoint;
  * **keep-k GC** — old checkpoints removed after a successful commit;
  * restore validates the stored paths and shapes against a template
    tree and raises ``ValueError`` on a mismatch (the wrong config).

Leaves are written as numpy arrays of their own dtype, except bfloat16,
which numpy lacks: a bf16 leaf is written as float32 (exact) and restore
casts every array to its template leaf's dtype, as the reference does. A
2-byte void array (how numpy stores the reference's bf16) is read as
bf16 bits. The data pipeline is stateless (batch i is a pure function of
seed and i), so resuming needs only the step counter.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.nn.module import flatten_params, tree_map_with_path

MANIFEST = "manifest.json"


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    """Atomically write ``tree`` (any tree of tensors) for ``step``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    entries = []
    arrays: Dict[str, np.ndarray] = {}
    for path, leaf in flatten_params(tree):
        arr = _to_numpy(leaf)
        arrays[path.replace("/", ".")] = arr
        entries.append({"path": path, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump({"step": step, "entries": entries}, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if re.fullmatch(r"step_\d{8}", d))
    for d in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if re.fullmatch(r"step_\d{8}", d)]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (values replaced, each
    leaf on its template leaf's device and in its dtype).

    Validates the manifest against the template's flattened paths; raises
    on mismatch (protects against restoring the wrong arch config)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    stored = {e["path"] for e in manifest["entries"]}
    tpl = dict(flatten_params(template))
    if stored != set(tpl):
        missing = set(tpl) - stored
        extra = stored - set(tpl)
        raise ValueError(f"checkpoint/template mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = {}
        for p, tpl_leaf in tpl.items():
            arr = data[p.replace("/", ".")]
            if list(arr.shape) != list(tpl_leaf.shape):
                raise ValueError(f"shape mismatch at {p}: ckpt {arr.shape} vs "
                                 f"template {tuple(tpl_leaf.shape)}")
            leaves[p] = _to_tensor(arr, tpl_leaf)
    return tree_map_with_path(lambda p, _: leaves[p], template), manifest["step"]
