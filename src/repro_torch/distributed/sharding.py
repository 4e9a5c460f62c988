"""Rule-based parameter/activation sharding over a torch ``DeviceMesh``
(port of ``repro.distributed.sharding``).

Mesh axes, as in the reference:
  * ``pod``   — cross-pod data parallelism (gradient all-reduce)
  * ``data``  — intra-pod data parallel + FSDP (ZeRO-3-style weight shard)
  * ``model`` — tensor/expert parallel

A **spec** (``Spec``) is the port's counterpart of a ``PartitionSpec``: a
tuple with one entry per tensor dimension (trailing entries may be left
out), each ``None`` (not sharded), a mesh-axis name, or a tuple of names
(the dimension sharded over several mesh axes, major to minor). ``()`` is
fully replicated. ``Spec`` is a tuple subclass, so a tree of specs can
hold tuples as containers (xLSTM's cell state) and still tell its leaves
apart; a spec compares equal to the plain tuple of its entries.

Rules are (regex over the '/'-joined param path) -> spec of the
UNSTACKED tensor; scanned layer groups ("groups/...") get a leading
``None`` for the stacking axis. First match wins. The table is the
reference's, rule for rule.

Profiles:
  * ``tp_fsdp``  — weights sharded over (data, model); optimizer state
    follows params (ZeRO-3 memory). The training default.
  * ``tp_only``  — weights sharded over model only, replicated over data
    (the serving profile).
  * ``replicated`` — pure data parallelism.

``tree_placements`` turns specs into DTensor placements, one per mesh
dimension: a mesh dimension the spec names at tensor dimension ``d`` is
``Shard(d)``, any other ``Replicate()``; a composite axis such as
``("pod", "data")`` is ``Shard(d)`` on both mesh dimensions, outer first
(DTensor shards a dimension over several mesh dimensions in mesh order,
JAX's major-to-minor).

``maybe_constrain`` is the reference's ``with_sharding_constraint`` on
logical axes ('dp', 'tp'): it does nothing unless a mesh is active
(``use_mesh``, set by the launcher and the dry-run) AND its input is a
DTensor; then it redistributes the input to the resolved placements.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from repro_torch.nn.module import tree_map, tree_map_with_path

Axis = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """One sharding entry per tensor dimension (see the module docstring)."""

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


Rules = List[Tuple[str, Tuple[Axis, ...]]]

PROFILES = ("tp_fsdp", "tp_only", "replicated")

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` the active mesh that ``maybe_constrain`` resolves its
    logical axes against (the reference's ``set_mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def active_mesh():
    """The innermost mesh set by ``use_mesh``, or None."""
    return _MESH.get()


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh-axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _dp(mesh) -> Axis:
    """The composite data-parallel axis: ('pod','data') on multi-pod."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def _size(mesh, ax: Axis) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes[a]
    return n


def resolve_logical(mesh, *logical) -> Spec:
    """Logical axes ('dp', 'tp', mesh names, tuples of them, None) as a
    spec over ``mesh``'s axes; an axis the mesh lacks resolves to None."""
    names = set(mesh.mesh_dim_names)

    def resolve(ax):
        if isinstance(ax, (tuple, list)):
            flat = []
            for a in ax:
                r = resolve(a)
                if isinstance(r, tuple):
                    flat.extend(r)
                elif r is not None:
                    flat.append(r)
            return tuple(flat) if flat else None
        if ax == "dp":
            got = tuple(a for a in ("pod", "data") if a in names)
            return got if got else None
        if ax == "tp":
            return "model" if "model" in names else None
        return ax if ax in names else None

    return Spec(resolve(a) for a in logical)


def placements_for(spec: Spec, mesh) -> tuple:
    """One DTensor placement per mesh dimension for a tensor of ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def maybe_constrain(x, *logical):
    """Redistribute the DTensor ``x`` to the logical axes resolved against
    the active mesh; ``x`` itself when no mesh is active or ``x`` is not a
    DTensor (every single-device path)."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements_for(resolve_logical(mesh, *logical), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def param_rules(profile: str, mesh=None) -> Rules:
    if profile not in PROFILES:
        raise ValueError(f"unknown sharding profile {profile!r}; have {PROFILES}")
    fs = "data" if profile == "tp_fsdp" else None     # FSDP axis (or not)
    mdl = "model" if profile != "replicated" else None
    if profile == "replicated":
        return [(r".*", ())]
    return [
        # embeddings: vocab shards over model, so the LM head keeps its
        # logits vocab-sharded
        (r".*pos_embed/table$", (None, mdl)),
        (r".*(^|/)embed/table$", (mdl, None)),
        (r".*frontend_proj/w$", (None, mdl)),
        (r".*lm_head/w$", (fs, mdl)),
        # attention projections
        (r".*/(q|k|v)/w$", (fs, mdl)),
        (r".*/o/w$", (mdl, fs)),
        (r".*/(qnorm|knorm)/scale$", ()),
        # attention gating module (paper) — tiny, replicate
        (r".*/gate/(w|b|w1|b1|w2|b2)$", ()),
        # dense MLP
        (r".*/mlp/(up|gate)/w$", (fs, mdl)),
        (r".*/mlp/down/w$", (mdl, fs)),
        # MoE: expert-TP (the expert dim is uneven across archs: unsharded);
        # shared experts are plain MLPs
        (r".*/moe/router/w$", ()),
        (r".*/moe/w_(gate|up)$", (None, fs, mdl)),
        (r".*/moe/w_down$", (None, mdl, fs)),
        (r".*/moe/shared/(up|gate)/w$", (fs, mdl)),
        (r".*/moe/shared/down/w$", (mdl, fs)),
        # griffin / RG-LRU
        (r".*/griffin/(in_x|in_gate)/w$", (fs, mdl)),
        (r".*/griffin/out/w$", (mdl, fs)),
        (r".*/rglru/(w_a|w_x)/w$", (fs, mdl)),
        (r".*/rglru/lambda$", (mdl,)),
        (r".*/griffin/conv/w$", (None, mdl)),
        (r".*/griffin/conv/b$", (mdl,)),
        # xLSTM
        (r".*/blk/up/w$", (fs, mdl)),
        (r".*/blk/(q|k|v)/w$", (fs, mdl)),
        (r".*/blk/down/w$", (mdl, fs)),
        (r".*/blk/ifgate/w$", (mdl, None)),
        (r".*/blk/conv/w$", (None, mdl)),
        (r".*/blk/conv/b$", (mdl,)),
        (r".*/blk/(zifo|ff_up|ff_gate)/w$", (fs, mdl)),
        (r".*/blk/ff_down/w$", (mdl, fs)),
        (r".*/blk/(rz|ri|rf|ro)$", ()),
        # biases / norm scales / everything small: replicate
        (r".*", ()),
    ]


def spec_for_path(path: str, rules: Rules, stacked: bool) -> Spec:
    for pat, spec in rules:
        if re.match(pat, path):
            return Spec((None,) + spec if stacked else spec)
    return Spec()


def tree_param_specs(tree: Any, profile: str, mesh=None) -> Any:
    """Spec tree matching ``tree`` (params, or a ``TrainState`` whose
    leaves' paths end with param paths)."""
    rules = param_rules(profile, mesh)

    def one(path: str, leaf) -> Spec:
        stacked = "/groups/" in f"/{path}" or path.startswith("groups/")
        spec = spec_for_path(path, rules, stacked)
        # rank guard: never a spec longer than the tensor's rank
        return Spec(spec[: leaf.ndim]) if len(spec) > leaf.ndim else spec

    return tree_map_with_path(one, tree)


def tree_placements(tree: Any, profile: str, mesh) -> Any:
    """DTensor placements (one per mesh dimension) for every leaf of
    ``tree`` under ``profile`` (the reference's ``tree_shardings``)."""
    specs = tree_param_specs(tree, profile, mesh)
    return tree_map(lambda _, s: placements_for(s, mesh), tree, specs)


def distribute_tree(tree: Any, placements: Any, mesh) -> Any:
    """Every leaf of ``tree`` as a DTensor over ``mesh`` with its
    placements. Each rank cuts its shard from its own copy of the leaf
    (``src_data_rank=None``: no collective)."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda x, pl: distribute_tensor(x, mesh, list(pl), src_data_rank=None),
                    tree, placements)


def from_local_tree(tree: Any, placements: Any, mesh) -> Any:
    """Every leaf of ``tree`` as this rank's local shard of a DTensor with
    its placements (no copy, no collective). On a mesh where no placement
    splits a tensor the local shard is the whole leaf."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda x, pl: DTensor.from_local(x, mesh, list(pl), run_check=False),
                    tree, placements)


def local_tree(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as its local shard."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)


# --------------------------------------------------------------------------
# Activation / input shardings
# --------------------------------------------------------------------------
def batch_specs(batch: Any, mesh, shard_seq: bool = False,
                seq_axis: Optional[str] = None) -> Any:
    """tokens/labels (B,T): batch over (pod,data). ``shard_seq`` moves the
    sequence dim onto ``seq_axis`` ("data" for B=1 long-context decode,
    "model" for context-parallel prefill); batch stays on the dp axes when
    it still divides."""
    dp = _dp(mesh)
    n_dp = _size(mesh, dp)

    def one(leaf) -> Spec:
        if leaf.ndim >= 2 and shard_seq:
            b_ax = dp if leaf.shape[0] % n_dp == 0 else None
            return Spec((b_ax, seq_axis or "data") + (None,) * (leaf.ndim - 2))
        return Spec((dp,) + (None,) * (leaf.ndim - 1))

    return tree_map(one, batch)


def cache_specs_tree(cache_tpl: Any, mesh, cfg, batch: int) -> Any:
    """Decode-cache specs. KV tensors (B, S, Hkv, Dh): batch over the data
    axes when divisible, sequence over 'data' otherwise (the B=1
    long-context cell); d_head always over 'model'. Recurrent states
    shard their feature dim over 'model' when it divides."""
    dp = _dp(mesh)
    shard_batch = batch % _size(mesh, dp) == 0
    b_ax = dp if shard_batch else None
    n_model = axis_sizes(mesh)["model"]

    def one(path: str, leaf) -> Spec:
        stacked = path.startswith("groups/")
        shape = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)
        ndim = len(shape)
        if path.endswith("pos_ids"):
            spec: tuple = ()
        elif ndim == 4 and (path.endswith("/k") or path.endswith("/v")):
            spec = (b_ax, None if shard_batch else "data", None, "model")
        elif ndim >= 2 and shape[0] == batch:
            f_ax = "model" if shape[-1] % n_model == 0 else None
            spec = (b_ax,) + (None,) * (ndim - 2) + (f_ax,)
        elif ndim == 1 and shape[0] == batch:
            spec = (b_ax,)
        else:
            spec = ()
        return Spec((None,) + spec if stacked else spec)

    return tree_map_with_path(one, cache_tpl)


def spec_leaves(specs: Any) -> List[Tuple[str, Spec]]:
    """(path, spec) pairs of a spec tree, in ``flatten_params`` order."""
    return list(_leaves(specs, lambda t: isinstance(t, Spec)))


def placement_leaves(placements: Any) -> List[Tuple[str, tuple]]:
    """(path, placements) pairs of a placements tree, in ``flatten_params``
    order (a leaf is a tuple of DTensor ``Placement``s)."""
    from torch.distributed.tensor import Placement

    return list(_leaves(placements, lambda t: isinstance(t, tuple) and bool(t) and all(
        isinstance(p, Placement) for p in t)))


def _leaves(t, is_leaf, prefix=""):
    if is_leaf(t):
        yield prefix, t
    elif isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], is_leaf, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _leaves(v, is_leaf, f"{prefix}/{i}" if prefix else str(i))
    elif t is not None:
        raise TypeError(f"unexpected leaf {t!r} at {prefix!r}")


__all__ = [
    "PROFILES", "Rules", "Spec", "active_mesh", "axis_sizes", "batch_specs",
    "cache_specs_tree", "distribute_tree", "from_local_tree", "local_tree", "maybe_constrain",
    "param_rules", "placement_leaves", "placements_for", "resolve_logical",
    "spec_for_path",
    "spec_leaves", "tree_param_specs", "tree_placements", "use_mesh",
]
