"""Training launcher: a mesh, the profile's placements and the
checkpointed loop (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --smoke --steps 50 --profile tp_fsdp --device cpu

Without ``--device`` it trains on the card (``cuda``). The reference's
flags map as they do there:
  --profile tp_fsdp|tp_only|replicated   weight placements (``tree_placements``)
  --microbatch N                         gradient accumulation
  --grad-compress                        int8 gradient compression + error feedback
  --no-remat                             kept for the reference's CLI (the port's
                                         eager step recomputes nothing)
  --mesh host|single|multi               (1, n) over this process's group, or the
                                         16x16 / 2x16x16 production mesh

``train_on_mesh`` is the body: it places the ``TrainState`` with the
profile's placements as DTensors over the mesh, resumes from the latest
checkpoint as the reference does, and runs the port's
``make_train_step``. One card only: on a mesh where no placement splits a
tensor (every mesh dimension a placement shards has size 1) each DTensor's
local shard is the whole tensor, and the step runs on the local shards,
which is the plain loop's computation, bitwise. A mesh that splits a
tensor raises ``NotImplementedError``: multi-card training (ROADMAP 5.5)
cannot be measured on one H100. Nothing routes around the kernels: every
registered arch, its smoke config (f32, Dh 8 or 16) and its full one,
trains through the flash backward on the card; a head dim the flash
kernels do not take raises there.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import apply_method, get_arch
from repro_torch.data import SyntheticLM, SyntheticLMConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    batch_specs,
    from_local_tree,
    local_tree,
    placement_leaves,
    placements_for,
    tree_placements,
    use_mesh,
)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, mesh_size
from repro_torch.nn.module import flatten_params, tree_map
from repro_torch.optim import AdamWConfig, linear_warmup_linear_decay
from repro_torch.train.step import TrainState, TrainTask, init_train_state, make_train_step


def _splitting_placements(mesh, *placement_trees) -> list:
    """(path, placements) of every leaf whose placements shard it over a
    mesh dimension of size > 1."""
    sizes = list(mesh.mesh.shape)
    return [(path, pl) for tree in placement_trees for path, pl in placement_leaves(tree)
            if any(p.is_shard() and sizes[d] > 1 for d, p in enumerate(pl))]


def _to_device(batch, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}


def train_on_mesh(task: TrainTask, data, mesh, profile: str = "tp_fsdp", *,
                  steps: int, batch_kind: str = "clm", device="cuda",
                  state: Optional[TrainState] = None, ckpt_dir: Optional[str] = None,
                  ckpt_every: int = 0, log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Train ``task`` on batches ``0..steps-1`` of ``data`` (anything with
    ``SyntheticLM``'s ``batch(index, kind)``) over ``mesh``.

    Starts from ``state`` (a plain ``TrainState`` on ``device``; it is
    consumed) or ``init_train_state(0)``, placed with ``profile``'s
    placements; when ``ckpt_dir`` holds a checkpoint, from its latest
    step. Writes a checkpoint every ``ckpt_every`` steps. Returns the
    final state as DTensors (``state``) and as plain tensors (``local``),
    the ``placements``, every step's ``losses`` and wall time
    (``step_s``, to a synchronize on the card) and ``start_step``.
    Raises ``NotImplementedError`` on a mesh that splits a tensor."""
    dev = resolve_device(device)
    if state is None:
        state = init_train_state(0, task, device=dev)
    placements = tree_placements(state, profile, mesh)
    template = _to_device(data.batch(0, batch_kind), "meta")
    bspecs = batch_specs(template, mesh)
    batch_pl = tree_map(lambda _, s: placements_for(s, mesh), template, bspecs)
    split = _splitting_placements(mesh, placements, batch_pl)
    if split:
        raise NotImplementedError(
            f"the {tuple(mesh.mesh.shape)} mesh under {profile!r} splits "
            f"{len(split)} tensors (first {split[0][0]}: {split[0][1]}). Training across "
            f"cards (ROADMAP 5.5) cannot be measured on the one H100 the port runs on: "
            f"this launcher takes a mesh whose every sharded dimension has size 1")
    # one card: each DTensor's local shard is its whole tensor (no copy)
    local = local_tree(from_local_tree(state, placements, mesh))
    del state
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        local, start = restore_checkpoint(ckpt_dir, local)
        log(f"[resume] step {start}")
    step_fn = make_train_step(task)
    losses, durs = [], []
    with use_mesh(mesh):
        for step in range(start, steps):
            batch = _to_device(data.batch(step, batch_kind), dev)
            t0 = time.perf_counter()
            local, metrics = step_fn(local, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            durs.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            if (step + 1) % max(steps // 10, 1) == 0:
                log(f"step {step + 1:6d} loss {losses[-1]:.4f} {durs[-1] * 1e3:.0f}ms")
            if ckpt_every and ckpt_dir and (step + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step + 1, local)
    return {"state": from_local_tree(local, placements, mesh), "local": local,
            "placements": placements, "losses": losses, "step_s": durs, "start_step": start}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--method", default="clipped_softmax")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--profile", default="tp_fsdp")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--mesh", choices=["host", "single", "multi"], default="host")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.mesh == "host":
        mesh = make_host_mesh(args.device)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over "
          f"{mesh_size(mesh)} devices")

    spec = get_arch(args.arch)
    cfg = spec.smoke() if args.smoke else spec.full()
    cfg = apply_method(cfg, args.method)
    cfg = dataclasses.replace(cfg, remat=not args.no_remat,
                              max_seq_len=max(cfg.max_seq_len, args.seq_len))
    loss_kind = "clm" if cfg.causal else "frames"
    task = TrainTask(
        cfg=cfg, loss_kind=loss_kind,
        optimizer=AdamWConfig(lr=args.lr),
        schedule=linear_warmup_linear_decay(args.steps // 10, args.steps),
        microbatch=args.microbatch, grad_compress=args.grad_compress)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                         batch_size=args.batch_size))
    run = train_on_mesh(task, data, mesh, args.profile, steps=args.steps,
                        batch_kind=loss_kind, device=args.device, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every)
    if run["start_step"]:
        print(f"resumed at step {run['start_step']}")
    if run["step_s"]:
        print(f"median step {np.median(run['step_s']) * 1e3:.0f} ms")
    print(f"params {sum(x.numel() for _, x in flatten_params(run['local'].params))}")


if __name__ == "__main__":
    main()
