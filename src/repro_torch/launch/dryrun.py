"""Multi-pod dry-run: lay every (architecture x input shape) cell out on
the production meshes and count its roofline terms (port of
``repro.launch.dryrun``).

Usage (CPU only; a process of its own, since the production meshes start
torch's ``fake`` backend as the process's one default group):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

Where the reference lowers and compiles each cell with XLA, the port runs
the cell's step once, eagerly, on ``meta`` DTensors over the fake mesh:
the step's state, batch and cache are placed with the profile's
placements (``distributed.sharding``), the step is the port's own
``make_train_step`` / ``make_prefill_step`` / ``make_decode_step``, and
``launch.roofline.StepCounter`` reads each device's flops, bytes and
collectives from the local ops DTensor runs. Meta tensors compute
nothing, so nothing runs on any card: the kernel wrappers' ``meta``
branches take their plain versions, and the count is of the plain math,
as XLA counts the reference's lowered math. A plain tensor made inside
the step (positions, masks) counts as replicated
(``implicit_replication``).

No extrapolation: the reference compiles scanned layers, whose loop body
XLA's cost analysis counts once, and fits two unrolled depths to recover
the full count (``extrapolated_costs``). Eager execution runs every
layer, so the count is already the full depth's. The report keys are
the reference's (``roofline``), with ``roofline_scanned_raw`` equal to
it.

An op DTensor has no sharding rule for marks its cell ``error`` with
the op's name (``op``); the run goes on with the next cell. Reports land
in ``experiments/dryrun_torch/<cell>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, apply_method, cache_specs, get_arch, input_specs, list_archs
from repro_torch.distributed.sharding import (
    Spec,
    axis_sizes,
    batch_specs,
    cache_specs_tree,
    distribute_tree,
    placements_for,
    tree_param_specs,
    use_mesh,
)
from repro_torch.launch.mesh import close_mesh, make_production_mesh, mesh_size
from repro_torch.launch.roofline import StepCounter, analyze, model_flops_infer, model_flops_train
from repro_torch.models.transformer import ModelConfig, model_init
from repro_torch.nn.module import flatten_params, tree_map
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (
    TrainTask,
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


class _MetaFactories(TorchDispatchMode):
    """Tensor factories (random draws, zeros, fills) land on ``meta``; the
    generator's small seed draws (``randint``, read back by
    ``split_keys``) stay real. ``model_init`` then builds every shape
    without allocating the weights."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        factory = not any(isinstance(a, torch.Tensor) for a in args)
        if factory and "device" in kwargs and \
                func._overloadpacket is not torch.ops.aten.randint:
            kwargs["device"] = torch.device("meta")
            if "generator" in kwargs:
                kwargs["generator"] = None
        elif "generator" in kwargs and any(
                isinstance(a, torch.Tensor) and a.is_meta for a in args):
            kwargs["generator"] = None
        return func(*args, **kwargs)


def param_shapes(cfg: ModelConfig):
    """``model_init``'s tree of ``cfg`` as meta tensors (shapes, dtypes)."""
    with _MetaFactories():
        return model_init(0, cfg, device="cpu")


def train_state_shapes(task: TrainTask):
    """``init_train_state``'s ``TrainState`` as meta tensors."""
    with _MetaFactories():
        return init_train_state(0, task, device="cpu")


def active_param_count(cfg: ModelConfig) -> int:
    """Parameter count weighted by MoE activation (top_k/n_experts) —
    feeds MODEL_FLOPS = 6*N_active*D."""
    total = 0
    for path, leaf in flatten_params(param_shapes(cfg)):
        n = leaf.numel()
        if "/moe/w_" in f"/{path}":
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        total += n
    return total


def param_count_full(cfg: ModelConfig) -> int:
    return sum(leaf.numel() for _, leaf in flatten_params(param_shapes(cfg)))


def build_step(cfg: ModelConfig, shape, mesh, profile: str, microbatch: int = 1
               ) -> Tuple[Callable[[], Any], Dict[str, int]]:
    """The step of one cell on meta DTensors placed over ``mesh`` (plain
    meta tensors, one device, when ``mesh`` is None): returns (a call that
    runs it once, {"argument_bytes": the step's inputs' bytes on one
    device})."""

    def place(tree, specs_of):
        if mesh is None:
            return tree
        specs = specs_of(tree, mesh)
        return distribute_tree(tree, tree_map(lambda _, s: placements_for(s, mesh), tree,
                                              specs), mesh)

    def param_specs(tree, m):
        return tree_param_specs(tree, profile, m)

    batch = input_specs(cfg, shape)
    if shape.step == "train":
        task = TrainTask(cfg=cfg, loss_kind="clm" if cfg.causal else "frames",
                         optimizer=AdamWConfig(), microbatch=microbatch)
        state = place(train_state_shapes(task), param_specs)
        batch = place(batch, batch_specs)
        step = make_train_step(task)
        return (lambda: step(state, batch)), _arg_bytes(state, batch)
    params = place(param_shapes(cfg), param_specs)
    if shape.step == "prefill":
        batch = place(batch, batch_specs)
        step = make_prefill_step(cfg)
        return (lambda: step(params, batch)), _arg_bytes(params, batch)
    # decode: one token against a seq_len cache; the token's batch over the
    # data axes when it divides them, else replicated (the reference's)

    def token_specs(tree, m):
        n_dp = mesh_size(m) // axis_sizes(m)["model"]
        return batch_specs(tree, m) if shape.global_batch % n_dp == 0 else {"tokens": Spec()}

    cache = place(cache_specs(cfg, shape),
                  lambda t, m: cache_specs_tree(t, m, cfg, shape.global_batch))
    tok = place({"tokens": batch["tokens"]}, token_specs)["tokens"]
    step = make_decode_step(cfg)
    pos = shape.seq_len - 1
    return (lambda: step(params, cache, tok, pos)), _arg_bytes(params, cache, tok)


def _arg_bytes(*trees) -> Dict[str, int]:
    n = 0
    for t in trees:
        for _, x in flatten_params(t):
            loc = x.to_local() if hasattr(x, "to_local") else x
            n += loc.numel() * loc.element_size()
    return {"argument_bytes": int(n)}


def count_step(cfg: ModelConfig, shape, mesh, profile: str, microbatch: int = 1):
    """(StepCounts, memory stats) of one run of the cell's step on
    ``mesh`` (one device without DTensor when None)."""
    from torch.distributed.tensor.experimental import implicit_replication

    if mesh is None:
        run, mem = build_step(cfg, shape, None, profile, microbatch)
        with StepCounter() as counter:
            run()
        return counter.counts(), mem
    with use_mesh(mesh):
        run, mem = build_step(cfg, shape, mesh, profile, microbatch)
        with implicit_replication(), StepCounter() as counter:
            try:
                run()
            except Exception as e:
                if counter.last_op is not None:
                    e.add_note(f"while DTensor dispatched {counter.last_op}")
                raise
    return counter.counts(), mem


def _error_text(err: BaseException) -> str:
    return "\n".join([str(err) or type(err).__name__, *getattr(err, "__notes__", [])])


def _op_name(err: BaseException) -> Optional[str]:
    """The first op an error names (its message, then the note
    ``count_step`` adds: the last op DTensor dispatched)."""
    m = re.search(r"\b(aten|_c10d_functional|prims)\.[A-Za-z0-9_]+(\.[A-Za-z0-9_]+)?",
                  _error_text(err))
    return m.group(0) if m else None


def lower_cell(arch_id: str, shape_name: str, mesh, profile: str = "tp_fsdp",
               method: str = "clipped_softmax", microbatch: int = 1,
               moe_exec: Optional[str] = None, n_layers: Optional[int] = None
               ) -> Dict[str, Any]:
    """Run and count one cell; return a JSON-serializable report.
    ``n_layers`` cuts the depth (tests)."""
    spec = get_arch(arch_id)
    shape = SHAPES[shape_name]
    why = spec.skipped(shape_name)
    if why is not None:
        return {"arch": arch_id, "shape": shape_name, "status": "skipped",
                "reason": why}

    cfg = apply_method(spec.full(), method)
    cfg = dataclasses.replace(
        cfg, max_seq_len=max(shape.seq_len + 8, cfg.window or 0))
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if moe_exec and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, exec_mode=moe_exec))
    n_chips = mesh_size(mesh)
    report: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": list(mesh.mesh.shape),
        "profile": profile, "method": method, "status": "ok",
    }

    t0 = time.time()
    counts, mem = count_step(cfg, shape, mesh, profile, microbatch)
    report["trace_s"] = round(time.time() - t0, 2)

    if shape.step == "train":
        mf = model_flops_train(active_param_count(cfg), shape.global_batch * shape.seq_len)
    elif shape.step == "prefill":
        mf = model_flops_infer(active_param_count(cfg), shape.global_batch * shape.seq_len)
    else:
        mf = model_flops_infer(active_param_count(cfg), shape.global_batch)

    roof = analyze(counts, n_chips, model_flops_total=mf, memory_stats=mem)
    report["roofline"] = roof.as_dict()
    report["roofline_scanned_raw"] = report["roofline"]
    report["n_ops"] = counts.n_ops
    report["params_total"] = param_count_full(cfg)
    report["params_active"] = active_param_count(cfg)
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--profile", default="tp_fsdp")
    ap.add_argument("--method", default="clipped_softmax")
    ap.add_argument("--moe-exec", default=None, choices=[None, "dense", "dispatch"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="accepted for the reference's CLI; the port never extrapolates")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for multi in meshes:
        close_mesh()               # one default group a process: one mesh at a time
        mesh = make_production_mesh(multi_pod=multi)
        mesh_tag = "2x16x16" if multi else "16x16"
        for arch, shp in [(a, s) for a in archs for s in shapes]:
            tag = f"{arch}__{shp}__{mesh_tag}__{args.profile}"
            path = os.path.join(args.out, tag + ".json")
            try:
                rep = lower_cell(arch, shp, mesh, args.profile, args.method,
                                 moe_exec=args.moe_exec)
            except Exception as e:  # noqa: BLE001 — report and continue
                rep = {"arch": arch, "shape": shp, "mesh": mesh_tag,
                       "status": "error", "op": _op_name(e), "error": _error_text(e)[:2000],
                       "traceback": traceback.format_exc()[-3000:]}
            rep["mesh_tag"] = mesh_tag
            with open(path, "w") as f:
                json.dump(rep, f, indent=1)
            st = rep["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_fail += st == "error"
            extra = ""
            if st == "ok":
                r = rep["roofline"]
                extra = (f"bottleneck={r['bottleneck']} "
                         f"c={r['compute_s']:.3f}s m={r['memory_s']:.3f}s "
                         f"x={r['collective_s']:.3f}s trace={rep['trace_s']}s")
            elif st == "error":
                first = rep["error"].splitlines()[0][:140] if rep["error"] else ""
                extra = f"op={rep['op']} {first}"
            print(f"[{st:7s}] {tag} {extra}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
