"""Minimal functional module system (port of ``repro.nn.module``).

Layers are plain functions over nested dicts of tensors, exactly the
layout of the JAX package's param pytrees, so converted reference weights
(``repro_torch.convert``) drop in unchanged:

    init(gen, ...) -> params (nested dict of tensors)
    apply(params, x, ...) -> y

``jax.random`` keys become ``torch.Generator``s: ``split_keys`` forks a
generator into ``n`` independent children seeded from it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple

import torch

Params = Any  # nested dict/list of tensors


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy: params stored in ``param_dtype``, math in
    ``compute_dtype``, softmax/norm accumulation in f32."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @staticmethod
    def bf16() -> "DTypePolicy":
        return DTypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)

    @staticmethod
    def bf16_params_f32() -> "DTypePolicy":
        # f32 master weights, bf16 math
        return DTypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)


F32 = DTypePolicy()


def normal_init(gen: torch.Generator, shape: Tuple[int, ...], std: float,
                dtype) -> torch.Tensor:
    """``std * N(0, 1)`` drawn in f32 on the generator's device, then cast."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def split_keys(gen: torch.Generator, n: int) -> List[torch.Generator]:
    """Fork ``gen`` into ``n`` child generators on its device, each seeded
    by one draw from ``gen`` (the counterpart of ``jax.random.split``)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen, device=gen.device)
    out = []
    for s in seeds.tolist():
        g = torch.Generator(device=gen.device)
        g.manual_seed(int(s))
        out.append(g)
    return out


def flatten_params(params: Params, prefix: str = ""
                   ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ('/'-joined path, leaf) pairs in deterministic order."""
    if isinstance(params, dict):
        for k in sorted(params.keys()):
            yield from flatten_params(params[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from flatten_params(v, f"{prefix}/{i}" if prefix else str(i))
    elif params is None:
        return
    else:
        yield prefix, params


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for _, p in flatten_params(params))


def param_bytes(params: Params) -> int:
    return sum(int(p.numel()) * p.element_size() for _, p in flatten_params(params))


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """Map ``fn`` over the leaves of one or more same-structure trees
    (NamedTuples keep their type; ``None`` stays ``None``, an empty
    subtree as in a JAX pytree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        kids = [tree_map(fn, t, *rs) for t, *rs in zip(tree, *rest)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves of a tree of dicts, lists and
    tuples (NamedTuples keep their type), paths as ``flatten_params``
    names them; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)
    if tree is None:
        return None
    return fn(prefix, tree)


def tree_stack(trees: List[Params]) -> Params:
    """Stack identical trees along a new leading axis (the scanned
    ``groups`` layout)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_slice(tree: Params, i) -> Params:
    """Leaf-wise ``x[i]``: views into the stacked tensors, so in-place
    writes through a slice land in the stack."""
    return tree_map(lambda x: x[i], tree)


def cast_tree(tree: Params, dtype) -> Params:
    """Floating leaves cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
