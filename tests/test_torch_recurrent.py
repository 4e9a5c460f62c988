"""The port's Griffin modules and ring caches against the JAX package's,
on the CPU, in float32.

Each check converts the reference's weights (``model_init`` / the module
inits, numpy in between) and feeds both packages the same numpy inputs
from a seed. Modules at atol 1e-5: ``conv1d_apply`` with a history
state, ``rglru_scan`` (the port's sequential recurrence against the
reference's associative scan, which rounds in another order) and
``rglru_step``, and ``griffin_block_apply`` whole, step by step and in
chunks with the state carried. Models at atol 1e-4: recurrentgemma-smoke
cache-free logits, a scanned variant (2 groups and a 2-block tail), and
the chunked ring prefill (window 8, a 20-token prompt in chunks 8/8/4)
over ``init_paged_cache``, vanilla and clipped, logits and every cache
leaf against the reference's; its last chunk also against the port's
cache-free forward, with the clipped softmax's gamma pinned to the ring
length (a static ``gamma = -alpha / 8`` there)."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import apply_method as japply
from repro.configs.recurrentgemma_9b import smoke as jsmoke
from repro_torch.configs.base import apply_method as tapply
from repro_torch.configs.recurrentgemma_9b import smoke as tsmoke
from repro_torch.convert import from_jax_params
from repro_torch.nn.module import flatten_params, tree_map

jlay = importlib.import_module("repro.nn.layers")
jrec = importlib.import_module("repro.nn.recurrent")
jtr = importlib.import_module("repro.models.transformer")
tlay = importlib.import_module("repro_torch.nn.layers")
trec = importlib.import_module("repro_torch.nn.recurrent")
ttr = importlib.import_module("repro_torch.models.transformer")

MOD_ATOL, MODEL_ATOL = 1e-5, 1e-4
W = 32                                   # recurrent width of the module checks
_METHOD_NAME = {"vanilla": "vanilla", "clipped": "clipped_softmax",
                "gated": "gated_attention"}
_jax_apply = jax.jit(jtr.model_apply, static_argnums=(1,))


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_conv1d_with_history_state():
    jp = jlay.conv1d_init(jax.random.PRNGKey(1), W, 4)
    tp = _t(jp)
    x, state = _x((2, 7, W), 0), _x((2, 3, W), 1)
    for st in (None, state):
        jy, js = jlay.conv1d_apply(jp, jnp.asarray(x), None if st is None else jnp.asarray(st))
        ty, ts = tlay.conv1d_apply(tp, torch.from_numpy(x),
                                   None if st is None else torch.from_numpy(st))
        _close(ty, jy, MOD_ATOL)
        _close(ts, js, 0)


def test_rglru_scan_and_step():
    cfg_j, cfg_t = jrec.RGLRUConfig(width=W), trec.RGLRUConfig(width=W)
    jp = jrec.rglru_init(jax.random.PRNGKey(2), cfg_j)
    tp = _t(jp)
    assert tp["lambda"].dtype == torch.float32
    x, h0 = _x((2, 11, W), 3), _x((2, W), 4)
    for h in (None, h0):
        jy, jl = jrec.rglru_scan(jp, jnp.asarray(x), None if h is None else jnp.asarray(h))
        ty, tl = trec.rglru_scan(tp, torch.from_numpy(x),
                                 None if h is None else torch.from_numpy(h))
        _close(ty, jy, MOD_ATOL)
        _close(tl, jl, MOD_ATOL)
    jy, jl = jrec.rglru_step(jp, jnp.asarray(x[:, 0]), jnp.asarray(h0))
    ty, tl = trec.rglru_step(tp, torch.from_numpy(x[:, 0]), torch.from_numpy(h0))
    _close(ty, jy, MOD_ATOL)
    _close(tl, jl, MOD_ATOL)
    assert cfg_t == trec.RGLRUConfig(**dataclasses.asdict(cfg_j))


def test_griffin_block_full_steps_and_chunks():
    """The whole sequence, one decode step at a time and in chunks 5/1/6
    with the state carried, against the reference's one-shot block."""
    cfg_j, cfg_t = jrec.RGLRUConfig(width=W), trec.RGLRUConfig(width=W)
    jp = jrec.griffin_block_init(jax.random.PRNGKey(3), 24, cfg_j)
    tp = _t(jp)
    x = _x((2, 12, 24), 5)
    jy, jst = jrec.griffin_block_apply(jp, jnp.asarray(x), cfg_j,
                                       jrec.griffin_init_state(2, cfg_j))
    ty, tst = trec.griffin_block_apply(tp, torch.from_numpy(x), cfg_t)
    _close(ty, jy, MOD_ATOL)
    for bounds in ([(i, i + 1) for i in range(12)], [(0, 5), (5, 6), (6, 12)]):
        state = trec.griffin_init_state(2, cfg_t)
        outs = []
        for lo, hi in bounds:
            y, state = trec.griffin_block_apply(tp, torch.from_numpy(x[:, lo:hi]), cfg_t,
                                                state)
            outs.append(y)
        _close(torch.cat(outs, dim=1), jy, MOD_ATOL)
        _close(state["h"], jst["h"], MOD_ATOL)
        _close(state["conv"], jst["conv"], MOD_ATOL)
    _close(tst["h"], jst["h"], MOD_ATOL)


def _models(method="vanilla", **replace):
    kw = {"alpha": 4.0} if method == "clipped" else {}
    jc = dataclasses.replace(japply(jsmoke(), _METHOD_NAME[method], **kw), **replace)
    tc = dataclasses.replace(tapply(tsmoke(), _METHOD_NAME[method], **kw), **replace)
    jp = jtr.model_init(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


@pytest.mark.parametrize("layout", ["unrolled", "scanned+tail"])
def test_model_logits_match_reference(layout):
    replace = {} if layout == "unrolled" else dict(n_layers=8, scan_layers=True)
    jc, jp, tc, tp = _models("gated", **replace)
    assert tc.tail_pattern == jc.tail_pattern
    if layout != "unrolled":
        assert "groups" in tp and set(tp["tail"]) == {"t0", "t1"}
        assert tp["groups"]["b0"]["griffin"]["rglru"]["lambda"].shape == (2, 64)
    tokens = np.random.default_rng(7).integers(0, 128, (2, 13))
    jl, jaux = _jax_apply(jp, jc, {"tokens": jnp.asarray(tokens)})
    tl, taux = ttr.model_apply(tp, tc, {"tokens": torch.from_numpy(tokens)},
                               collect_acts=True)
    _close(tl, jl, MODEL_ATOL)
    if layout != "unrolled":
        _close(taux["act_stats"], jaux["act_stats"], MODEL_ATOL)
        assert len(taux["attn_outputs"]) == 2          # the tail's blocks


def _chunked(apply, params, cfg, cache, prompt, bounds, tensor):
    logits = []
    for lo, hi in bounds:
        tok = tensor(prompt[None, lo:hi])
        pos = tensor(np.array([lo], np.int32))
        out, aux = apply(params, cfg, {"tokens": tok}, cache=cache, pos=pos)
        cache = aux["cache"]
        logits.append(out)
    return logits, cache


@pytest.mark.parametrize("method", ["vanilla", "clipped"])
def test_chunked_ring_prefill(method):
    jc, jp, tc, tp = _models(method)
    prompt = np.random.default_rng(11).integers(0, 128, 20).astype(np.int32)
    bounds = [(0, 8), (8, 16), (16, 20)]
    jcache = jtr.init_paged_cache(jc, 1, 32, 4, 8)
    tcache = ttr.init_paged_cache(tc, 1, 32, 4, 8, device="cpu")
    assert tcache["layers"][0]["b2"]["k"].shape == (1, 8, 1, 16)    # L = window
    jl, jcache = _chunked(_jax_apply, jp, jc, jcache, prompt, bounds, jnp.asarray)
    tl, tcache = _chunked(ttr.model_apply, tp, tc, tcache, prompt, bounds,
                          lambda a: torch.from_numpy(np.asarray(a, np.int64)))
    for got, want in zip(tl, jl):
        _close(got, want, MODEL_ATOL)
    flat_j = dict(flatten_params(_t(jax.tree_util.tree_map(np.asarray, jcache))))
    flat_t = dict(flatten_params(tcache))
    assert flat_t.keys() == flat_j.keys()
    for path, leaf in flat_t.items():
        _close(leaf, flat_j[path], MODEL_ATOL)
    # the last chunk against the port's own cache-free forward, gamma pinned
    # to the ring length (8) rather than resolved from the 20 tokens
    ref_cfg = tc if method == "vanilla" else tapply(tsmoke(), "clipped_softmax",
                                                    gamma=-4.0 / 8)
    full, _ = ttr.model_apply(tp, ref_cfg, {"tokens": torch.from_numpy(prompt[None].astype(
        np.int64))})
    _close(tl[-1], full[:, 16:], MODEL_ATOL)
