"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, on the CPU, on the production meshes.

The reference runs on ``jax.sharding.AbstractMesh``es (no devices); the
port on ``DeviceMesh``es of torch's ``fake`` backend (256 or 512 ranks in
this one process, rank 0; a module fixture starts and destroys the
group, one mesh at a time, since a process has one default group):

  * every parameter of every registered arch (``full()`` and
    ``smoke()``), under ``tp_fsdp``, ``tp_only`` and ``replicated``, on
    16x16 and 2x16x16: the port's spec equals the reference's
    ``PartitionSpec`` path by path, and the DTensor placements it turns
    into give rank 0 the local shape the spec implies (the reference's
    ``NamedSharding.shard_shape`` where the mesh divides the dimension,
    else its padded shard, ceil(size / n));
  * ``batch_specs`` (also with the sequence sharded) and
    ``cache_specs_tree`` for every ``SHAPES`` cell an arch runs;
  * ``active_param_count``, ``param_count_full`` and ``model_flops_*``
    exactly the reference's for every arch;
  * ``maybe_constrain``: the identity without a mesh or a DTensor, a
    redistribution to the resolved placements under one.
"""
import functools
import math
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import cache_specs as jcache_specs
from repro.configs import get_arch as jget_arch
from repro.configs import input_specs as jinput_specs
from repro.configs import list_archs as jlist_archs
from repro.distributed import sharding as jsh
from repro.launch import roofline as jroof
from repro.models.transformer import model_init as jmodel_init
from repro.nn.module import flatten_params as jflatten
from repro_torch.configs import SHAPES, cache_specs, get_arch, input_specs, list_archs
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troof
from repro_torch.nn.module import flatten_params
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

ARCHS = list_archs()
PROFILES = ("tp_fsdp", "tp_only", "replicated")
MESHES = {"16x16": False, "2x16x16": True}


def reference_dryrun():
    """``repro.launch.dryrun``, imported without its side effect: it sets
    XLA_FLAGS to 512 host devices for a jax that is not yet initialized,
    so jax is initialized first and the variable restored."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jdry
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdry


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    """(port DeviceMesh on the fake backend, reference AbstractMesh)."""
    multi = MESHES[request.param]
    tmesh.close_mesh()
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    jmesh = AbstractMesh(tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names))
    yield mesh, jmesh
    tmesh.close_mesh()


@functools.lru_cache(maxsize=None)
def _shapes(arch, maker):
    """(reference param shapes as [(path, shape)], port meta params)."""
    jcfg = getattr(jget_arch(arch), maker)()
    tcfg = getattr(get_arch(arch), maker)()
    jtree = jax.eval_shape(lambda: jmodel_init(jax.random.PRNGKey(0), jcfg))
    return jtree, tdry.param_shapes(tcfg)


def _jspec(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def _expected_local(shape, spec, mesh, jmesh):
    try:
        return tuple(NamedSharding(jmesh, P(*spec)).shard_shape(tuple(shape)))
    except ValueError:     # uneven: XLA pads each shard to ceil(size / n)
        sizes = tsh.axis_sizes(mesh)
        out = []
        for d, n in enumerate(shape):
            ax = spec[d] if d < len(spec) else None
            k = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))) \
                if ax is not None else 1
            out.append(-(-n // k))
        return tuple(out)


def test_production_meshes(meshes):
    mesh, jmesh = meshes
    assert tuple(mesh.mesh_dim_names) == tuple(jmesh.axis_names)
    assert tuple(mesh.mesh.shape) == tuple(jmesh.shape.values())
    assert dist.get_world_size() == math.prod(mesh.mesh.shape)
    with pytest.raises(RuntimeError, match="process of its own"):
        tmesh.make_production_mesh(multi_pod=mesh.mesh.ndim == 2)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("maker", ("full", "smoke"))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_placements_equal_reference(meshes, arch, maker, profile):
    mesh, jmesh = meshes
    jtree, ttree = _shapes(arch, maker)
    want = [(p, _jspec(s), tuple(x.shape)) for (p, x), (_, s) in zip(
        jflatten(jtree), jflatten_specs(jsh.tree_param_specs(jtree, profile, jmesh)))]
    got = tsh.spec_leaves(tsh.tree_param_specs(ttree, profile, mesh))
    assert [p for p, _ in got] == [p for p, _, _ in want]
    assert [s for _, s in got] == [s for _, s, _ in want]
    assert [tuple(x.shape) for _, x in flatten_params(ttree)] == [s for _, _, s in want]
    # placements -> rank 0's local shape, once per distinct (shape, placements)
    placements = dict(tsh.placement_leaves(tsh.tree_placements(ttree, profile, mesh)))
    seen = {}
    for (path, spec, shape), (_, leaf) in zip(want, flatten_params(ttree)):
        pl = placements[path]
        assert pl == tsh.placements_for(spec, mesh)
        key = (shape, pl)
        if key not in seen:
            seen[key] = tuple(tsh.distribute_tree({"x": leaf}, {"x": pl}, mesh)["x"]
                              .to_local().shape)
        assert seen[key] == _expected_local(shape, spec, mesh, jmesh), (path, spec, pl)
    sharded = [p for p, s in got if any(a is not None for a in s)]
    assert bool(sharded) == (profile != "replicated")


def jflatten_specs(tree):
    """(path, PartitionSpec) pairs of a reference spec tree, in
    ``flatten_params`` order (both sort dict keys; a PartitionSpec is a
    leaf)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp), spec)
            for kp, spec in leaves]


def _cells(arch):
    return [s for s in SHAPES if get_arch(arch).skipped(s) is None]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_reference(meshes, arch):
    mesh, jmesh = meshes
    jcfg, tcfg = jget_arch(arch).full(), get_arch(arch).full()
    assert _cells(arch) == [s for s in JSHAPES if jget_arch(arch).skipped(s) is None]
    for name in _cells(arch):
        jshape, tshape = JSHAPES[name], SHAPES[name]
        jb, tb = jinput_specs(jcfg, jshape), input_specs(tcfg, tshape)
        for kw in ({}, {"shard_seq": True, "seq_axis": "model"}, {"shard_seq": True}):
            want = {k: _jspec(v) for k, v in jsh.batch_specs(jb, jmesh, **kw).items()}
            got = tsh.batch_specs(tb, mesh, **kw)
            assert got == want, (name, kw)
        if tshape.step != "decode":
            continue
        jc, tc = jcache_specs(jcfg, jshape), cache_specs(tcfg, tshape)
        want = [(p, _jspec(s)) for p, s in jflatten_specs(
            jsh.cache_specs_tree(jc, jmesh, jcfg, jshape.global_batch))]
        got = tsh.spec_leaves(tsh.cache_specs_tree(tc, mesh, tcfg, tshape.global_batch))
        assert got == want, name
        assert [p for p, _ in flatten_params(tc)] == [p for p, _ in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_model_flop_counts_equal_reference(arch):
    jdry = reference_dryrun()
    jcfg, tcfg = jget_arch(arch).full(), get_arch(arch).full()
    n_act, n_full = tdry.active_param_count(tcfg), tdry.param_count_full(tcfg)
    assert n_act == jdry.active_param_count(jcfg)
    assert n_full == jdry.param_count_full(jcfg)
    assert (n_act < n_full) == (tcfg.moe is not None)
    for shape in SHAPES.values():
        toks = shape.global_batch * shape.seq_len
        assert troof.model_flops_train(n_act, toks) == jroof.model_flops_train(n_act, toks)
        assert troof.model_flops_infer(n_act, toks) == jroof.model_flops_infer(n_act, toks)


def test_param_rules_are_the_reference_table():
    assert ARCHS == jlist_archs()
    jm = AbstractMesh((16, 16), ("data", "model"))
    for profile in PROFILES:
        want = [(pat, _jspec(s)) for pat, s in jsh.param_rules(profile, jm)]
        assert tsh.param_rules(profile) == want
    with pytest.raises(ValueError, match="unknown sharding profile"):
        tsh.param_rules("tp_seq_typo")
    rules = tsh.param_rules("tp_fsdp")
    assert tsh.spec_for_path("groups/b0/attn/q/w", rules, True) == (None, "data", "model")
    assert tsh.spec_for_path("layers/0/b0/mlp/down/w", rules, False) == ("model", "data")


def test_maybe_constrain(meshes):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, _ = meshes
    x = torch.zeros((64, 4, 2, 32), device="meta")
    assert tsh.maybe_constrain(x, "dp", None, None, "tp") is x     # no mesh
    d = tsh.distribute_tree({"x": x}, {"x": tsh.placements_for((), mesh)}, mesh)["x"]
    assert tsh.maybe_constrain(d, "dp", None, None, "tp") is d
    with tsh.use_mesh(mesh):
        assert tsh.active_mesh() is mesh
        assert tsh.maybe_constrain(x, "dp", None, None, "tp") is x  # not a DTensor
        y = tsh.maybe_constrain(d, "dp", None, None, "tp")
        assert isinstance(y, DTensor)
        want = [Shard(0)] * (mesh.mesh.ndim - 1) + [Shard(3)]
        assert list(y.placements) == want
        assert tsh.maybe_constrain(y, "dp", None, None, "tp") is y
        z = tsh.maybe_constrain(y, None, None, None, None)
        assert all(isinstance(p, Replicate) for p in z.placements)
    assert tsh.active_mesh() is None
    dp = ("pod", "data") if mesh.mesh.ndim == 3 else ("data",)
    assert tsh.resolve_logical(mesh, "dp", ("dp", "tp"), "tp", "nope", None) == \
        (dp, dp + ("model",), "model", None, None)


def test_composite_axis_shards_outer_first():
    """``("pod", "data")`` is ``Shard(d)`` on both mesh dimensions, pod
    outer: rank 0 of 2x16x16 holds the first 1/32 of the dimension."""
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")
        mesh = np.zeros((2, 16, 16))

    assert tsh.placements_for((("pod", "data"), None, "model"), _Mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements_for((None, "model"), _Mesh) == (Replicate(), Replicate(), Shard(1))
