"""The port's ``generate`` and dense KV cache against the JAX package's,
on the CPU, in float32.

``repro_torch.serving.generate`` and ``repro.serving.generate`` get the
same converted weights, prompts and key: tokens must be bitwise equal,
greedy and sampled (temperature with top-k: one key split per token, the
(B, vocab) Gumbel block drawn from it), with ``eos_id`` padding, and at
``max_new_tokens`` 0 and 1; on qwen3-smoke (vanilla, clipped alpha 4,
gated) and on recurrentgemma-smoke (griffin, griffin, local_attn, window
8) with a prompt under the window (one-shot prefill through the shared-
``pos`` ring write) and past it (chunked prefill, also forced with
``prefill_chunk``).

Below ``generate``: ``init_cache`` has the reference's leaves, shapes and
dtypes, and ``model_apply`` over a dense cache matches the reference's
logits at atol 1e-4 for a shared-``pos`` prefill and decode, per-row
``pos`` with ``active`` masks, and the shared-``pos`` ring write at T > 1,
at a slot the write clamps.

``ContinuousBatcher(paged=False)``: greedy tokens equal the port's own
``generate`` per request and the reference's dense batcher, speculation
on equals off, and a W8A8 engine (``qconfig=``) over the fp dense cache
equals the reference's. Clipped runs are compared only at equal
``max_len`` (gamma resolves from it)."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import apply_method as japply
from repro.configs.qwen3_14b import smoke as jqwen
from repro.configs.recurrentgemma_9b import smoke as jrg
from repro_torch.configs.base import apply_method as tapply
from repro_torch.configs.qwen3_14b import smoke as tqwen
from repro_torch.configs.recurrentgemma_9b import smoke as trg
from repro_torch.convert import from_jax_params
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

jtr = importlib.import_module("repro.models.transformer")
jserve = importlib.import_module("repro.serving")
jqc = importlib.import_module("repro.quant.qconfig")
ttr = importlib.import_module("repro_torch.models.transformer")
tserve = importlib.import_module("repro_torch.serving")
tqc = importlib.import_module("repro_torch.quant.qconfig")
tfa = importlib.import_module("repro_torch.kernels.flash_attention")
tprng = importlib.import_module("repro_torch.random")

METHODS = {"vanilla": ("vanilla", {}), "clipped": ("clipped_softmax", {"alpha": 4.0}),
           "gated": ("gated_attention", {})}
FAMILIES = {"qwen": (jqwen, tqwen), "rg": (jrg, trg)}
_MODELS: dict = {}
_jax_apply = jax.jit(jtr.model_apply, static_argnums=(1,))


def _models(family, method, **replace):
    """(jax cfg, jax params, port cfg, port params), built once each."""
    key = (family, method, tuple(sorted(replace.items())))
    if key not in _MODELS:
        jsmoke, tsmoke = FAMILIES[family]
        name, kw = METHODS[method]
        jc = dataclasses.replace(japply(jsmoke(), name, **kw), **replace)
        tc = dataclasses.replace(tapply(tsmoke(), name, **kw), **replace)
        jp = jtr.model_init(jax.random.PRNGKey(0), jc)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, jp, tc, tp)
    return _MODELS[key]


def _prompt(b, t, seed=1):
    return np.random.default_rng(seed).integers(1, 120, (b, t)).astype(np.int32)


def _both_generate(family, method, prompt, key=3, prefill_chunk=None, **gen_kw):
    jc, jp, tc, tp = _models(family, method)
    ref = np.asarray(jserve.generate(jp, jc, jnp.asarray(prompt),
                                     jserve.GenerateConfig(**gen_kw),
                                     key=jax.random.PRNGKey(key),
                                     prefill_chunk=prefill_chunk))
    out = tserve.generate(tp, tc, torch.from_numpy(prompt), tserve.GenerateConfig(**gen_kw),
                          key=torch.tensor([0, key]), prefill_chunk=prefill_chunk)
    assert out.dtype == torch.int32
    return ref, out.numpy()


# ---------------------------------------------------------------------------
# the dense cache
# ---------------------------------------------------------------------------
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("case", ["qwen", "qwen-scanned-bf16", "rg", "rg-no-ring"])
def test_init_cache_leaves_equal_reference(case):
    family = case.split("-")[0]
    replace = {"qwen-scanned-bf16": dict(scan_layers=True),
               "rg-no-ring": dict(max_seq_len=8)}.get(case, {})
    jc, _, tc, _ = _models(family, "vanilla", **replace)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if "bf16" in case else (None, None)
    jcache = jtr.init_cache(jc, 3, 24, dtype=jdt)
    tcache = ttr.init_cache(tc, 3, 24, dtype=tdt, device="cpu")
    jl, tl = list(_leaves(jcache)), list(_leaves(tcache))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    names = {p[-1] for p, _ in tl}
    if family == "rg":
        assert {"h", "conv", "k", "v"} <= names
        assert ("pos_ids" in names) == (case == "rg")


def test_model_apply_dense_cache_logits_match_reference():
    """qwen3-smoke, clipped: a shared-pos prefill and decode step over a
    dense cache of 16, then per-row pos with active masks (a padding
    token, a write past the row, a dead row) whose dropped writes leave
    the caches equal."""
    jc, jp, tc, tp = _models("qwen", "clipped")
    tokens = _prompt(2, 6, seed=7)
    jcache, tcache = jtr.init_cache(jc, 2, 16), ttr.init_cache(tc, 2, 16, device="cpu")

    def step(tok, pos, active=None):
        nonlocal jcache, tcache
        jl, jaux = _jax_apply(jp, jc, {"tokens": jnp.asarray(tok)}, cache=jcache,
                              pos=jnp.asarray(pos) if np.ndim(pos) else pos,
                              active=None if active is None else jnp.asarray(active))
        tl, taux = ttr.model_apply(tp, tc, {"tokens": torch.from_numpy(tok)}, cache=tcache,
                                   pos=torch.from_numpy(pos) if np.ndim(pos) else pos,
                                   active=None if active is None else torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        jcache, tcache = jaux["cache"], taux["cache"]

    step(tokens, 0)                                   # shared-pos prefill
    step(tokens[:, :1], 6)                            # shared-pos decode
    # per-row chunks: row 0 with a padding token, row 1 at 14..16 (the
    # write at 16 falls past the row and is dropped)
    step(tokens[:, :3], np.array([7, 14], np.int32),
         np.array([[True, True, False], [True, True, True]]))
    step(tokens[:, :1], np.array([9, 3], np.int32),   # row 1 dead
         np.array([True, False]))
    for (path, j), (_, t) in zip(_leaves(jcache), _leaves(tcache)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("method", ["vanilla", "clipped"])
def test_shared_pos_ring_write_clamps_like_reference(method):
    """recurrentgemma-smoke over a ring of 8 slots at a shared pos: a
    prefill of 5, then a block of 4 at pos 5 (slot 5 would overflow; the
    write clamps to slot 4, as ``dynamic_update_slice`` does), then a
    decode step. The updated ring is read for T > 1 too."""
    jc, jp, tc, tp = _models("rg", method)
    tokens = _prompt(2, 5, seed=11)
    jcache, tcache = jtr.init_cache(jc, 2, 32), ttr.init_cache(tc, 2, 32, device="cpu")
    for tok, pos in ((tokens, 0), (tokens[:, :4], 5), (tokens[:, :1], 9)):
        jl, jaux = _jax_apply(jp, jc, {"tokens": jnp.asarray(tok)}, cache=jcache, pos=pos)
        tl, taux = ttr.model_apply(tp, tc, {"tokens": torch.from_numpy(tok)}, cache=tcache,
                                   pos=pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        jcache, tcache = jaux["cache"], taux["cache"]
    ring = tcache["layers"][0]["b2"]["pos_ids"]
    np.testing.assert_array_equal(ring.numpy(),
                                  np.asarray(jcache["layers"][0]["b2"]["pos_ids"]))
    assert ring[0].tolist() == [0, 9, 2, 3, 5, 6, 7, 8]      # slot 1 from pos 9


# ---------------------------------------------------------------------------
# generate, token for token
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", list(METHODS))
def test_generate_greedy_equals_reference(method):
    before = tfa.launches
    ref, out = _both_generate("qwen", method, _prompt(2, 5), max_new_tokens=6)
    np.testing.assert_array_equal(out, ref)
    assert tfa.launches == before             # CPU tensors: the plain path


@pytest.mark.parametrize("method", ["vanilla", "gated"])
def test_generate_sampled_equals_reference(method):
    """Temperature 0.8 with top-k 20: the one-key categorical path."""
    ref, out = _both_generate("qwen", method, _prompt(3, 9, seed=4), key=5,
                              max_new_tokens=6, temperature=0.8, top_k=20)
    np.testing.assert_array_equal(out, ref)
    assert len({tuple(r) for r in out[:, 9:].tolist()}) == 3


def test_generate_eos_pads_like_reference():
    """eos_id set to a token the first row emits early: that row is padded
    with pad_id afterwards, the other keeps decoding."""
    prompt = _prompt(2, 5)
    _, probe = _both_generate("qwen", "vanilla", prompt, max_new_tokens=6)
    eos = int(probe[0, 5 + 1])
    ref, out = _both_generate("qwen", "vanilla", prompt, max_new_tokens=6, eos_id=eos,
                              pad_id=3)
    np.testing.assert_array_equal(out, ref)
    assert out[0, 5 + 1] == eos and (out[0, 5 + 2:] == 3).all()


def test_sample_token_at_equals_reference():
    """The batcher's position-keyed draw for one row, under a raw key:
    bitwise the reference's, and the per-row sampler's for that seed."""
    logits = np.random.default_rng(6).normal(size=(128,)).astype(np.float32) * 3
    gen_kw = dict(temperature=0.7, top_k=20)
    ref = jserve.decode.sample_token_at(jnp.asarray(logits), jserve.GenerateConfig(**gen_kw),
                                        jax.random.PRNGKey(7), 11)
    tgen = tserve.GenerateConfig(**gen_kw)
    out = tserve.sample_token_at(torch.from_numpy(logits), tgen, tprng.PRNGKey(7), 11)
    rows = tserve.sample_rows(torch.from_numpy(logits)[None], tgen, torch.tensor([7]),
                              torch.tensor([11]))
    assert int(out) == int(ref) == int(rows[0])


@pytest.mark.parametrize("n", [0, 1])
def test_generate_zero_and_one_new_tokens(n):
    ref, out = _both_generate("qwen", "clipped", _prompt(2, 5), max_new_tokens=n)
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (2, 5 + n)


@pytest.mark.parametrize("t, method, chunk, sampled", [
    (6, "vanilla", None, False),       # under the window: one-shot ring prefill
    (16, "clipped", None, False),      # past it: chunked prefill
    (16, "gated", 4, False),           # forced chunks of 4
    (16, "vanilla", None, True),       # sampled past the window
], ids=["under-window", "past-window", "prefill-chunk", "sampled"])
def test_generate_ring_config_equals_reference(t, method, chunk, sampled):
    gen_kw = dict(max_new_tokens=6)
    if sampled:
        gen_kw.update(temperature=0.8, top_k=20)
    ref, out = _both_generate("rg", method, _prompt(2, t, seed=t), prefill_chunk=chunk,
                              **gen_kw)
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# ContinuousBatcher(paged=False)
# ---------------------------------------------------------------------------
DENSE = dict(batch_size=2, max_len=32, paged=False, token_budget=8)


def _requests(prompts, max_new=6):
    return [(u, p, max_new) for u, p in enumerate(prompts)]


def _batch(batcher_cls, req_cls, params, cfg, reqs, **kw):
    b = batcher_cls(params, cfg, **{**DENSE, **kw})
    for u, p, n in reqs:
        b.submit(req_cls(uid=u, prompt=p, max_new_tokens=n))
    b.run()
    return {r.uid: r.output.tolist() for r in b.done}, b


def _port_batch(tp, tc, reqs, **kw):
    out, b = _batch(tserve.ContinuousBatcher, tserve.Request, tp, tc, reqs,
                    device="cpu", debug_audit=True, **kw)
    assert not b.paged and b._live_width() is None
    assert len(out) == len(reqs) and not b.failed
    return out, b


def _own_generate(tp, tc, reqs):
    return {u: tserve.generate(tp, tc, torch.from_numpy(p)[None],
                               tserve.GenerateConfig(max_new_tokens=n))[0, len(p):].tolist()
            for u, p, n in reqs}


@pytest.mark.parametrize("family, method", [("qwen", "vanilla"), ("qwen", "clipped"),
                                            ("qwen", "gated"), ("rg", "gated")])
def test_dense_batcher_equals_reference_and_own_generate(family, method):
    """Four requests over two slots (the second occupants reuse the rows)
    at a budget of 8 (multi-chunk prefill; on rg, prompts past the window)
    against the reference's dense batcher; then per request against the
    port's generate, for the clipped softmax with max_new_tokens set so
    that generate's max_len (T + max_new) is the engine's 32, since gamma
    resolves from it."""
    jc, jp, tc, tp = _models(family, method)
    rng = np.random.default_rng(3)
    reqs = _requests([rng.integers(1, 120, size=n).astype(np.int32) for n in (5, 19, 11, 3)])
    ref, _ = _batch(jserve.ContinuousBatcher, jserve.Request, jp, jc, reqs)
    out, b = _port_batch(tp, tc, reqs)
    assert out == ref
    assert b.forward_calls > 0 and all(len(v) == 6 for v in out.values())
    if method == "clipped":
        reqs = [(u, p, DENSE["max_len"] - len(p)) for u, p, _ in reqs[:2]]
        out, _ = _port_batch(tp, tc, reqs, token_budget=32)
    assert out == _own_generate(tp, tc, reqs)


def test_dense_batcher_spec_on_equals_spec_off():
    _, _, tc, tp = _models("qwen", "vanilla")
    motif = (3, 7, 11, 5)
    reqs = _requests([np.asarray((motif * 6)[:12 + u], np.int32) for u in range(3)], 12)
    off, _ = _port_batch(tp, tc, reqs, token_budget=16)
    on, b = _port_batch(tp, tc, reqs, token_budget=16, spec=tserve.SpecConfig(k=4))
    assert on == off == _own_generate(tp, tc, reqs)
    assert b.spec_drafted > 0 and b.spec_accepted > 0


def test_dense_w8a8_batcher_equals_reference():
    """W8A8 over the fp dense cache (kv_int8 defaults off without paged)."""
    jc, jp, tc, tp = _models("qwen", "clipped")
    reqs = _requests([_prompt(1, n, seed=n)[0] for n in (5, 19)], 4)
    ref, _ = _batch(jserve.ContinuousBatcher, jserve.Request, jp, jc, reqs,
                    qconfig=jqc.QConfig())
    out, b = _port_batch(tp, tc, reqs, qconfig=tqc.QConfig())
    assert out == ref
    assert not b.kv_int8 and b._qctx.mode == "int8"
