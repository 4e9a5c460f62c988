"""The port's int8 weight layout and the W8A8 product on it, on the CPU.

The int8 kernel reads ``w_q8`` K-major: the reference's (K, N) codes,
stored as an (N, K) row-major array seen through ``.t()`` (strides
(1, K)). Every maker of the codes gives that layout with the reference's
values bit for bit: ``quantize_weights_int8``, ``attach_int8_weights``
(unrolled and scanned, with ``tree_slice`` of the stacked leaf),
``build_int8_cache`` and ``convert.from_jax_params``. The kernel's
wrapper refuses any other layout rather than copy per call, and its
plan (route, tile width, CTAs) is checked where it is pure arithmetic. On
the CPU ``int8_matmul`` runs its plain version, which on K-major weights
equals the reference's Pallas kernel in interpret mode."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import apply_method as japply
from repro.configs.qwen3_14b import smoke as jsmoke
from repro_torch.configs.base import apply_method as tapply
from repro_torch.configs.qwen3_14b import smoke as tsmoke
from repro_torch.convert import from_jax_params

jw8 = importlib.import_module("repro.quant.int8_weights")
jim = importlib.import_module("repro.kernels.int8_matmul")
jtr = importlib.import_module("repro.models.transformer")
jmod = importlib.import_module("repro.nn.module")
tw8 = importlib.import_module("repro_torch.quant.int8_weights")
tim = importlib.import_module("repro_torch.kernels.int8_matmul")
tmod = importlib.import_module("repro_torch.nn.module")


def _rand(shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift
            ).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _k_major(t):
    """(..., K, N) int8 stored with its last two axes transposed."""
    k, n = t.shape[-2:]
    return t.dtype == torch.int8 and t.stride()[-2:] == (1, k) and \
        t.transpose(-1, -2).is_contiguous()


def _trees(scan, seed=3):
    jc = dataclasses.replace(japply(jsmoke(), "gated_attention"), scan_layers=scan)
    tc = dataclasses.replace(tapply(tsmoke(), "gated_attention"), scan_layers=scan)
    jp = jtr.model_init(jax.random.PRNGKey(seed), jc)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(40, 24), (64, 16), (128, 1040)], ids=str)
def test_quantize_weights_int8_is_k_major_and_bitwise(shape, dtype):
    w = _rand(shape, 80, 0.05)
    tw = torch.from_numpy(w)
    jw = jnp.asarray(w)
    if dtype == "bfloat16":
        tw, jw = tw.bfloat16(), jw.astype(jnp.bfloat16)
    tqw, ts = tim.quantize_weights_int8(tw)
    jqw, js = jim.quantize_weights_int8(jw)
    assert tqw.shape == shape and _k_major(tqw) and tim.k_major(tqw)
    _eq(tqw, jqw)
    _eq(ts, js)


@pytest.mark.parametrize("scan", [False, True], ids=["layers", "groups"])
def test_attach_int8_weights_gives_k_major_leaves(scan):
    jc, _, jp, tp = _trees(scan)
    ja = jw8.attach_int8_weights(jp)
    ta = tw8.attach_int8_weights(tp)
    jflat, tflat = dict(jmod.flatten_params(ja)), dict(tmod.flatten_params(ta))
    q8 = [p for p in tflat if p.endswith("w_q8")]
    assert q8 and all(_k_major(tflat[p]) for p in q8)
    for p in q8:
        _eq(tflat[p], jflat[p])
    if scan:
        # each layer's slice is a K-major (K, N) view of the stack
        for g in range(jc.n_groups):
            tl = dict(tmod.flatten_params(tmod.tree_slice(ta["groups"], g)))
            jl = dict(jmod.flatten_params(jax.tree_util.tree_map(lambda x: x[g],
                                                                 ja["groups"])))
            sliced = [p for p in tl if p.endswith("w_q8")]
            assert sliced and all(tl[p].dim() == 2 and tim.k_major(tl[p]) for p in sliced)
            for p in sliced:
                _eq(tl[p], jl[p])


@pytest.mark.parametrize("scan", [False, True], ids=["layers", "groups"])
def test_stacked_slices_share_the_one_int8_copy(scan):
    """tree_slice carves views: the tree holds one int8 copy of each
    weight, and the attached leaves take exactly K * N bytes each."""
    _, _, _, tp = _trees(scan)
    ta = tw8.attach_int8_weights(tp)
    leaves = [t for p, t in tmod.flatten_params(ta) if p.endswith("w_q8")]
    assert sum(t.untyped_storage().nbytes() for t in leaves) == sum(t.numel() for t in leaves)
    if scan:
        stacked = [t for p, t in tmod.flatten_params(ta["groups"]) if p.endswith("w_q8")]
        for g in range(stacked[0].shape[0]):
            sl = [t for p, t in tmod.flatten_params(tmod.tree_slice(ta["groups"], g))
                  if p.endswith("w_q8")]
            for s, t in zip(sl, stacked):
                assert s.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()


def test_build_int8_cache_is_k_major_and_bitwise():
    _, _, jp, tp = _trees(False)
    jcache, tcache = jw8.build_int8_cache(jp), tw8.build_int8_cache(tp)
    assert sorted(jcache) == sorted(tcache) and tcache
    for path, (wq, s) in tcache.items():
        assert _k_major(wq), path
        _eq(wq, jcache[path][0])
        _eq(s, jcache[path][1])


@pytest.mark.parametrize("scan", [False, True], ids=["layers", "groups"])
def test_from_jax_params_stores_w_q8_k_major(scan):
    """A reference tree that carries int8 leaves converts them K-major
    with equal values; every other leaf keeps its row-major layout."""
    jc, tc, jp, _ = _trees(scan)
    ja = jw8.attach_int8_weights(jp)
    ta = from_jax_params(jax.tree_util.tree_map(np.asarray, ja), tc, device="cpu")
    jflat, tflat = dict(jmod.flatten_params(ja)), dict(tmod.flatten_params(ta))
    assert sorted(jflat) == sorted(tflat)
    for p, leaf in tflat.items():
        if p.endswith("w_q8"):
            assert _k_major(leaf), p
        else:
            assert leaf.is_contiguous(), p
        if leaf.dtype == torch.bfloat16:
            _eq(leaf.float(), np.asarray(jflat[p], np.float32))
        else:
            _eq(leaf, jflat[p])


def test_check_refuses_a_row_major_w_q():
    x = torch.from_numpy(_rand((4, 64), 81))
    wq, ws = tim.quantize_weights_int8(torch.from_numpy(_rand((64, 32), 82, 0.05)))
    tim._check(x, wq, ws)                          # K-major: accepted
    with pytest.raises(ValueError, match="K-major.*quantize_weights_int8"):
        tim._check(x, wq.contiguous(), ws)         # the same values, row-major
    with pytest.raises(ValueError, match="K-major"):
        tim._check(x[:, :32].contiguous(), wq[:32], ws)   # a K slice: row stride 64, not 32
    tim._check(x, wq[:, :16], ws)   # an N slice keeps the row stride K: accepted
    assert tim.k_major(wq) and not tim.k_major(wq.contiguous())


SMS = 132


@pytest.mark.parametrize("shape", [(1, 64, 16), (8, 5120, 1024), (8, 17408, 5120),
                                   (16, 5120, 5120), (17, 5120, 5120), (130, 5120, 1040),
                                   (2048, 5120, 1024), (2048, 17408, 5120),
                                   (2048, 5120, 17408), (37, 96, 80)], ids=str)
def test_plan_routes_and_tiles(shape):
    """Route 0 exactly for M <= 16 with 8 or 16 code rows and one CTA per
    16-row strip; route 1 tiles of 128 or 256 with M code rows, its
    persistent CTAs never outnumbering the SMs or the tiles."""
    m, k, n = shape
    p = tim.plan(m, n, k, SMS)
    if m <= 16:
        assert p.route == 0 and p.code_rows == (8 if m <= 8 else 16)
        assert p.tile_n == 16 and p.ctas == -(-n // 16)
    else:
        assert p.route == 1 and p.code_rows == m and p.tile_n in (128, 256)
        assert 1 <= p.ctas == min(-(-m // 128) * -(-n // p.tile_n), SMS)


def test_plan_takes_the_measured_tile_widths():
    """At the padded mixed tick the plan takes 256-wide tiles where the
    waves allow them (gate/up, down, q/o) and 128 at k/v, as measured."""
    widths = {(k, n): tim.plan(2048, n, k, SMS).tile_n
              for k, n in ((5120, 17408), (17408, 5120), (5120, 5120), (5120, 1024))}
    assert widths == {(5120, 17408): 256, (17408, 5120): 256, (5120, 5120): 256,
                      (5120, 1024): 128}


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 64, 16), (37, 96, 80), (17, 128, 1040)], ids=str)
def test_int8_matmul_on_k_major_weights_matches_reference(shape, dtype, static):
    m, k, n = shape
    x = _rand((m, k), 90 + m, 1.3, 0.4)
    w = _rand((k, n), 91 + n, 0.05)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    tqw, ts = tim.quantize_weights_int8(torch.from_numpy(w))
    jqw, js = jim.quantize_weights_int8(jnp.asarray(w))
    assert tim.k_major(tqw)
    kw = dict(x_scale=0.0213, x_zero=117.0) if static else {}
    launches = tim.launches
    out = tim.int8_matmul(tx, tqw, ts, **kw)
    assert tim.launches == launches                 # CPU tensors: the plain version
    assert out.dtype == torch.float32 and out.shape == (m, n)
    _eq(out, jim.int8_matmul(jx, jqw, js, interpret=True, **kw))
