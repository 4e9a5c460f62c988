"""The reference's own ``opt_tiny`` serving tests, run on the port.

Copies of tests in ``tests/test_serving_engine.py``,
``tests/test_paged_cache.py`` and ``tests/test_prefix_cache.py`` that
serve ``opt_tiny(vocab=64, seq_len=32)`` at ``max_seq_len`` 64 (learned
positions, pre-LN layernorm blocks with biases, a relu MLP): the same
names, the same prompts and the same oracles, on the port's
``generate``, ``prefill``/``decode_one``, ``model_apply`` and
``ContinuousBatcher`` (CPU tensors), with the reference's initial weights
carried across by ``convert.from_jax_params``. Nothing in the serving
layer is specific to learned positions: the positions reach
``model_apply`` as they reach RoPE. Where a test names the reference's
batcher default, the port is given ``paged=False`` (the reference's
default; the port's is paged). The generate-based oracles are also held
against the reference's own tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import opt_tiny as jopt_tiny
from repro.models import model_init as jmodel_init
from repro.serving import GenerateConfig as JGenerateConfig
from repro.serving import generate as jgenerate
from repro_torch.configs import apply_method
from repro_torch.configs.paper_models import opt_tiny
from repro_torch.convert import from_jax_params
from repro_torch.models.transformer import init_cache, init_paged_cache, model_apply
from repro_torch.nn.module import tree_map
from repro_torch.serving import (ContinuousBatcher, GenerateConfig, Request, decode_one,
                                 generate, prefill)

BS = 8                                   # the prefix-cache tests' block size


def _cfgs(method="vanilla", **kw):
    j = dataclasses.replace(jopt_tiny(vocab=64, seq_len=32), max_seq_len=64)
    t = dataclasses.replace(opt_tiny(vocab=64, seq_len=32), max_seq_len=64)
    if method != "vanilla":
        from repro.configs import apply_method as japply
        j, t = japply(j, method, **kw), apply_method(t, method, **kw)
    return j, t


_SETUP: dict = {}


def _setup(method="vanilla", **kw):
    """(port cfg, port params) from the reference's PRNGKey(0) init, and
    (reference cfg, reference params)."""
    key = (method, tuple(sorted(kw.items())))
    if key not in _SETUP:
        jc, tc = _cfgs(method, **kw)
        jp = jmodel_init(jax.random.PRNGKey(0), jc)
        _SETUP[key] = (tc, from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc,
                                           device="cpu"), jc, jp)
    return _SETUP[key]


def _ref_rows(params, cfg, prompts, max_new):
    """Sequential greedy continuations, one request at a time."""
    return [generate(params, cfg, torch.from_numpy(np.asarray(p, np.int32))[None],
                     GenerateConfig(max_new_tokens=m))[0, len(p):].numpy()
            for p, m in zip(prompts, max_new)]


def _run_batcher(params, cfg, prompts, max_new, **kw):
    b = ContinuousBatcher(params, cfg, device="cpu", **kw)
    for u, (p, m) in enumerate(zip(prompts, max_new)):
        b.submit(Request(uid=u, prompt=p, max_new_tokens=m))
    out = {r.uid: r.output for r in b.run()}
    return b, out


def _set_tables(cache, table):
    for layer in cache["layers"]:
        layer["b0"]["block_table"] = torch.as_tensor(table, dtype=torch.int32)
    return cache


# ---------------------------------------------------------------------------
# tests/test_serving_engine.py
# ---------------------------------------------------------------------------
def test_generate_stops_at_eos_and_pads():
    cfg, params, jc, jp = _setup()
    prompt = np.arange(4, 10, dtype=np.int32)
    ref = _ref_rows(params, cfg, [prompt], [8])[0]
    jref = np.asarray(jgenerate(jp, jc, jnp.asarray(prompt)[None, :],
                                JGenerateConfig(max_new_tokens=8))[0, len(prompt):])
    np.testing.assert_array_equal(ref, jref)
    eos = int(ref[2])
    out = generate(params, cfg, torch.from_numpy(prompt)[None],
                   GenerateConfig(max_new_tokens=8, eos_id=eos))
    row = out[0, len(prompt):].numpy()
    k = list(row).index(eos)
    assert k <= 2
    np.testing.assert_array_equal(row[:k + 1], ref[:k + 1])
    assert (row[k + 1:] == 0).all(), row


def test_vector_pos_matches_scalar_decode():
    """One fused step with per-row positions == row-by-row scalar decode."""
    cfg, params, _, _ = _setup()
    prompts = [np.arange(4, 12), np.arange(5, 9), np.arange(3, 13)]
    L = 32
    pool = init_cache(cfg, len(prompts), L, device="cpu")
    toks, pos, rows = [], [], []
    for p in prompts:
        ll, c, t = prefill(params, cfg, torch.as_tensor(p, dtype=torch.int32)[None], L)
        rows.append(c)
        toks.append(int(torch.argmax(ll[0])))
        pos.append(t)
    for i, c in enumerate(rows):
        tree_map(lambda dst, src, i=i: dst[i].copy_(src[0]), pool, c)
    lg, _ = decode_one(params, cfg, pool, torch.tensor(toks, dtype=torch.int32)[:, None],
                       torch.tensor(pos, dtype=torch.int32), active=torch.ones(3, dtype=torch.bool))
    fused = torch.argmax(lg, -1)
    for i, c in enumerate(rows):
        lg1, _ = decode_one(params, cfg, c, torch.tensor([[toks[i]]], dtype=torch.int32), pos[i])
        assert int(torch.argmax(lg1[0])) == int(fused[i])


def test_inactive_rows_do_not_write():
    cfg, params, _, _ = _setup()
    cache = init_cache(cfg, 2, 32, device="cpu")
    old = tree_map(lambda x: x.clone(), cache)
    model_apply(params, cfg, {"tokens": torch.tensor([[5], [9]], dtype=torch.int32)},
                cache=cache, pos=torch.tensor([3, 7], dtype=torch.int32),
                active=torch.tensor([True, False]))
    for layer, before in zip(cache["layers"], old["layers"]):
        for kv in ("k", "v"):
            assert torch.equal(layer["b0"][kv][1], before["b0"][kv][1])
            assert not torch.equal(layer["b0"][kv][0], before["b0"][kv][0])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_staggered_arrivals_mixed_lengths_eos(paged):
    """Staggered arrivals + mixed prompt lengths + EOS mid-stream: every
    output equals a dedicated sequential generate."""
    cfg, params, _, _ = _setup()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 60, size=n).astype(np.int32) for n in (5, 3, 8, 4, 6)]
    max_new = [6, 8, 5, 7, 6]
    refs = _ref_rows(params, cfg, prompts, max_new)
    eos = int(refs[0][2])
    expected = []
    for r in refs:
        hits = np.flatnonzero(r == eos)
        expected.append(r[:hits[0] + 1] if hits.size else r)
    b = ContinuousBatcher(params, cfg, batch_size=2, max_len=64, eos_id=eos, paged=paged,
                          device="cpu")
    b.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=max_new[0]))
    b.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=max_new[1]))
    n_active = [b.step(), b.step()]
    for uid in (2, 3, 4):
        b.submit(Request(uid=uid, prompt=prompts[uid], max_new_tokens=max_new[uid]))
    done = sorted(b.run(), key=lambda r: r.uid)
    assert len(done) == 5 and n_active[0] == 2
    for req, exp in zip(done, expected):
        np.testing.assert_array_equal(req.output, exp, err_msg=f"uid={req.uid}")


def test_no_tick_clobbers_other_slots_cache():
    cfg, params, _, _ = _setup()
    b = ContinuousBatcher(params, cfg, batch_size=2, max_len=64, paged=False, device="cpu")
    b.submit(Request(uid=0, prompt=np.arange(4, 10, dtype=np.int32), max_new_tokens=10))
    b.step()
    b.step()

    def kv_row(cache, i):
        return [(blk["k"][i].clone(), blk["v"][i].clone())
                for g in cache["layers"] for blk in g.values()]

    before = kv_row(b.cache, 0)
    pos0 = b.slots[0].pos
    b.submit(Request(uid=1, prompt=np.arange(3, 11, dtype=np.int32), max_new_tokens=4))
    b.step()
    for (kb, vb), (ka, va) in zip(before, kv_row(b.cache, 0)):
        assert torch.equal(kb[:pos0], ka[:pos0]) and torch.equal(vb[:pos0], va[:pos0])
        assert not torch.equal(ka[pos0], kb[pos0]) or not torch.equal(va[pos0], vb[pos0])


def _sampled(params, cfg, prompts, max_new, seeds, **kw):
    b = ContinuousBatcher(params, cfg, gen=GenerateConfig(temperature=0.8, top_k=16),
                          device="cpu", **kw)
    for u, (p, m) in enumerate(zip(prompts, max_new)):
        b.submit(Request(uid=u, prompt=p, max_new_tokens=m, seed=seeds[u]))
    return {r.uid: r.output for r in b.run()}


def test_seeded_sampling_invariant_to_scheduling():
    cfg, params, _, _ = _setup()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(4, 60, size=n).astype(np.int32) for n in (5, 3, 8)]
    max_new, seeds = [6, 8, 5], [101, 102, 103]
    ref = _sampled(params, cfg, prompts, max_new, seeds, batch_size=2, max_len=32, paged=False)
    for kw in (dict(batch_size=3, max_len=32, paged=False),
               dict(batch_size=2, max_len=32, paged=True, block_size=8)):
        out = _sampled(params, cfg, prompts, max_new, seeds, **kw)
        for u in ref:
            np.testing.assert_array_equal(out[u], ref[u], err_msg=f"uid={u} {kw}")


def test_sampled_preemption_resumes_exactly():
    cfg, params, _, _ = _setup()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(4, 60, size=8).astype(np.int32) for _ in range(2)]
    max_new, seeds = [12, 12], [5, 6]
    kw = dict(batch_size=2, max_len=32, paged=True, block_size=4)
    roomy = _sampled(params, cfg, prompts, max_new, seeds, **kw)
    tight = _sampled(params, cfg, prompts, max_new, seeds, num_blocks=6, **kw)
    for u in roomy:
        np.testing.assert_array_equal(tight[u], roomy[u], err_msg=f"uid={u}")


def test_greedy_default_ignores_seed():
    cfg, params, _, _ = _setup()
    p = np.arange(4, 10, dtype=np.int32)
    ref = _ref_rows(params, cfg, [p], [4])[0]
    b = ContinuousBatcher(params, cfg, batch_size=1, max_len=32, device="cpu")
    b.submit(Request(uid=0, prompt=p, max_new_tokens=4, seed=123))
    np.testing.assert_array_equal(b.run()[0].output, ref)


# ---------------------------------------------------------------------------
# tests/test_paged_cache.py
# ---------------------------------------------------------------------------
def test_prefill_and_decode_bitwise_match_dense():
    """A scrambled-block-table paged cache and a dense cache: bitwise equal
    logits for a prefill and a per-row decode step."""
    cfg, params, _, _ = _setup()
    prompt = torch.arange(4, 12, dtype=torch.int32)[None]
    dcache = init_cache(cfg, 1, 32, device="cpu")
    dl, _ = model_apply(params, cfg, {"tokens": prompt}, cache=dcache, pos=0)
    pcache = _set_tables(init_paged_cache(cfg, 1, 32, num_blocks=6, block_size=8,
                                          device="cpu"), [[2, 0, 3, -1]])
    pl, _ = model_apply(params, cfg, {"tokens": prompt}, cache=pcache, pos=0)
    assert torch.equal(dl, pl)
    tok = torch.argmax(dl[:, -1:], -1).to(torch.int32)
    posv, act = torch.tensor([8], dtype=torch.int32), torch.tensor([True])
    dl2, _ = model_apply(params, cfg, {"tokens": tok}, cache=dcache, pos=posv, active=act)
    pl2, _ = model_apply(params, cfg, {"tokens": tok}, cache=pcache, pos=posv, active=act)
    assert torch.equal(dl2, pl2)


def test_inactive_rows_do_not_write_pool():
    cfg, params, _, _ = _setup()
    cache = _set_tables(init_paged_cache(cfg, 2, 32, num_blocks=8, block_size=8, device="cpu"),
                        [[0, 1, -1, -1], [2, 3, -1, -1]])
    model_apply(params, cfg, {"tokens": torch.tensor([[5], [9]], dtype=torch.int32)},
                cache=cache, pos=torch.tensor([3, 7], dtype=torch.int32),
                active=torch.tensor([True, False]))
    for layer in cache["layers"]:
        for kv in ("k", "v"):
            assert not layer["b0"][kv][2:4].any()
            assert layer["b0"][kv][0].any()


def test_same_tokens_for_same_prompts():
    """Dense and paged batchers emit the greedy tokens of a sequential
    generate per request, which are the reference's."""
    cfg, params, jc, jp = _setup()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 60, size=n).astype(np.int32) for n in (5, 3, 8, 4, 6)]
    max_new = [6, 8, 5, 7, 6]
    refs = _ref_rows(params, cfg, prompts, max_new)
    for p, m, ref in zip(prompts, max_new, refs):
        np.testing.assert_array_equal(
            ref, np.asarray(jgenerate(jp, jc, jnp.asarray(p)[None, :],
                                      JGenerateConfig(max_new_tokens=m))[0, len(p):]))
    _, dense = _run_batcher(params, cfg, prompts, max_new, batch_size=2, max_len=32,
                            paged=False)
    _, paged = _run_batcher(params, cfg, prompts, max_new, batch_size=2, max_len=32,
                            paged=True, block_size=8)
    for u, ref in enumerate(refs):
        np.testing.assert_array_equal(dense[u], ref, err_msg=f"uid={u}")
        np.testing.assert_array_equal(paged[u], ref, err_msg=f"uid={u}")


def test_clipped_softmax_paged_matches_dense():
    cfg, params, _, _ = _setup("clipped_softmax", alpha=4.0)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(4, 60, size=n).astype(np.int32) for n in (5, 7, 4)]
    max_new = [6, 5, 7]
    _, dense = _run_batcher(params, cfg, prompts, max_new, batch_size=2, max_len=32,
                            paged=False)
    _, paged = _run_batcher(params, cfg, prompts, max_new, batch_size=2, max_len=32,
                            paged=True, block_size=8)
    for u in range(len(prompts)):
        np.testing.assert_array_equal(paged[u], dense[u], err_msg=f"uid={u}")


def test_pool_exhaustion_preempts_and_resumes_exactly():
    cfg, params, _, _ = _setup()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(4, 60, size=8).astype(np.int32) for _ in range(2)]
    max_new = [12, 12]
    refs = _ref_rows(params, cfg, prompts, max_new)
    b, out = _run_batcher(params, cfg, prompts, max_new, batch_size=2, max_len=32,
                          paged=True, block_size=4, num_blocks=6)
    for u, ref in enumerate(refs):
        np.testing.assert_array_equal(out[u], ref, err_msg=f"uid={u}")
    assert b.allocator.available == b.num_blocks and (b.tables == -1).all()


# ---------------------------------------------------------------------------
# tests/test_prefix_cache.py
# ---------------------------------------------------------------------------
def _engine(**kw):
    cfg, params, _, _ = _setup()
    base = dict(batch_size=4, max_len=64, token_budget=48, paged=True, block_size=BS,
                num_blocks=32, prefix_cache=True, debug_audit=True, device="cpu")
    base.update(kw)
    return ContinuousBatcher(params, cfg, **base)


def _prompt(n, lo=4):
    return (np.arange(n) % 50 + lo).astype(np.int32)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_warm_equals_cold(kv_int8):
    b = _engine(kv_int8=kv_int8)
    p = _prompt(2 * BS + 5)
    b.submit(Request(uid=0, prompt=p.copy(), max_new_tokens=6))
    b.run()
    assert b.prefix_cache.hits == 0 and len(b.prefix_cache) == 2
    b.submit(Request(uid=1, prompt=p.copy(), max_new_tokens=6))
    b.run()
    assert b.prefix_cache.hits == 1 and b.shared_tokens == 2 * BS
    cold, warm = b.done[0].output, b.done[1].output
    np.testing.assert_array_equal(cold, warm)
    if not kv_int8:
        d = _engine(paged=False, prefix_cache=False)
        d.submit(Request(uid=2, prompt=p.copy(), max_new_tokens=6))
        d.run()
        np.testing.assert_array_equal(cold, d.done[0].output)
