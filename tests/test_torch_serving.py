"""The port's serving engine against the JAX package's, on the CPU.

``repro_torch.serving.ContinuousBatcher(paged=True, device="cpu")`` and
the reference ``repro.serving.ContinuousBatcher(paged=True)`` get the
same converted qwen3 smoke weights and the same requests; greedy tokens
must be equal for vanilla, clipped (alpha = 4) and gated attention over
fp and int8-KV pools, with a tight ``token_budget`` that forces
multi-chunk prefill. The port is compared with the reference's BATCHER
(not its ``generate``), so the clipped softmax resolves gamma from the
same logical length in both.

Inside the port: ``audit()`` is clean and no block leaks after every
run, prefix-cache warm admission equals cold, speculation on equals off
(with drafts accepted), and sampled recompute-resume and swap-resume
equal the unpreempted run. One whole-model check holds ``model_apply``
logits against the reference at atol 1e-4 (f32, two layers)."""
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
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

jtr = importlib.import_module("repro.models.transformer")
jserve = importlib.import_module("repro.serving")
ttr = importlib.import_module("repro_torch.models.transformer")
tserve = importlib.import_module("repro_torch.serving")
tpa = importlib.import_module("repro_torch.kernels.paged_attention")
tqc = importlib.import_module("repro_torch.quant.qconfig")
tw8 = importlib.import_module("repro_torch.quant.int8_weights")

METHODS = {"vanilla": {}, "clipped": {"alpha": 4.0}, "gated": {}}
_METHOD_NAME = {"vanilla": "vanilla", "clipped": "clipped_softmax",
                "gated": "gated_attention"}
ENGINE = dict(batch_size=2, max_len=64, paged=True, block_size=16,
              token_budget=8)
# one XLA compile per shape instead of one per primitive and shape
_jax_apply = jax.jit(jtr.model_apply, static_argnums=(1,))


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 120, size=n).astype(np.int32) for n in (5, 19)]


@pytest.fixture(scope="module")
def models():
    """Per method: (jax cfg, jax params, port cfg, port params)."""
    out = {}
    for m, kw in METHODS.items():
        jc = japply(jsmoke(), _METHOD_NAME[m], **kw)
        tc = tapply(tsmoke(), _METHOD_NAME[m], **kw)
        jp = jtr.model_init(jax.random.PRNGKey(0), jc)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc,
                             device="cpu")
        out[m] = (jc, jp, tc, tp)
    return out


def _run(batcher_cls, req_cls, params, cfg, prompts, max_new=6, **kw):
    b = batcher_cls(params, cfg, **{**ENGINE, **kw})
    for u, p in enumerate(prompts):
        b.submit(req_cls(uid=u, prompt=p, max_new_tokens=max_new))
    b.run()
    return {r.uid: r.output.tolist() for r in b.done}, b


def _port(models, method, prompts, **kw):
    _, _, tc, tp = models[method]
    out, b = _run(tserve.ContinuousBatcher, tserve.Request, tp, tc, prompts,
                  device="cpu", debug_audit=True, **kw)
    b.audit()
    assert b.allocator.available == b.num_blocks
    assert (b.tables == -1).all()
    return out, b


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "int8kv"])
@pytest.mark.parametrize("method", list(METHODS))
def test_greedy_tokens_equal_reference_batcher(models, method, kv_int8):
    jc, jp, _, _ = models[method]
    prompts = _prompts()
    ref, _ = _run(jserve.ContinuousBatcher, jserve.Request, jp, jc, prompts,
                  kv_int8=kv_int8)
    launches = tpa.launches
    out, b = _port(models, method, prompts, kv_int8=kv_int8)
    assert out == ref
    assert len(out) == 2 and all(len(v) == 6 for v in out.values())
    assert b.last_counts is not None and b.forward_calls > 0
    assert tpa.launches == launches            # CPU tensors: the plain path


def test_model_apply_logits_match_reference(models):
    """Whole model, two layers, f32: a prefill chunk then a decode step
    over a paged cache at per-row positions, and a cache-free forward."""
    jc, jp, tc, tp = models["clipped"]
    tokens = np.random.default_rng(7).integers(0, 128, (2, 6))
    jl, _ = _jax_apply(jp, jc, {"tokens": jnp.asarray(tokens)})
    tl, _ = ttr.model_apply(tp, tc, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    table = np.array([[3, 1, -1, -1], [0, 2, 4, -1]], np.int32)
    jcache = jtr.init_paged_cache(jc, 2, 32, 6, 8)
    tcache = ttr.init_paged_cache(tc, 2, 32, 6, 8, device="cpu")
    for jl_, tl_ in zip(jcache["layers"], tcache["layers"]):
        jl_["b0"]["block_table"] = jnp.asarray(table)
        tl_["b0"]["block_table"] = torch.from_numpy(table)
    pos = np.array([0, 9], np.int32)
    for step_tokens in (tokens, tokens[:, :1]):
        jl, jaux = _jax_apply(jp, jc, {"tokens": jnp.asarray(step_tokens)},
                              cache=jcache, pos=jnp.asarray(pos))
        tl, taux = ttr.model_apply(tp, tc, {"tokens": torch.from_numpy(step_tokens)},
                                   cache=tcache, pos=torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        jcache, tcache = jaux["cache"], taux["cache"]
        pos = pos + step_tokens.shape[1]


def test_bf16_int8kv_plain_path_promotes_like_reference(models):
    """bf16 compute over an int8 KV pool: the plain read returns f32 (the
    pools are dequantized), which promotes the rest of the layer to f32 in
    both packages."""
    jc, jp, tc, tp = models["gated"]
    jc = dataclasses.replace(jc, param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    tokens = np.random.default_rng(8).integers(0, 128, (2, 5))
    table = np.array([[1, -1, -1, -1], [0, 2, -1, -1]], np.int32)
    jcache = jtr.init_paged_cache(jc, 2, 32, 4, 8, kv_int8=True)
    tcache = ttr.init_paged_cache(tc, 2, 32, 4, 8, kv_int8=True, device="cpu")
    for jl_, tl_ in zip(jcache["layers"], tcache["layers"]):
        jl_["b0"]["block_table"] = jnp.asarray(table)
        tl_["b0"]["block_table"] = torch.from_numpy(table)
    pos = np.array([0, 4], np.int32)
    jl, _ = _jax_apply(jp, jc, {"tokens": jnp.asarray(tokens)}, cache=jcache,
                       pos=jnp.asarray(pos))
    tl, _ = ttr.model_apply(tp, tc, {"tokens": torch.from_numpy(tokens)},
                            cache=tcache, pos=torch.from_numpy(pos))
    # bf16 inputs to the first layer's projections: one bf16 ulp of slack
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-2, rtol=0)


def test_prefix_cache_warm_equals_cold(models):
    rng = np.random.default_rng(9)
    shared = rng.integers(1, 120, size=19).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 120, size=n).astype(np.int32)])
               for n in (3, 6)]
    outs = []
    for prefix_cache in (False, True):
        _, _, tc, tp = models["gated"]
        b = tserve.ContinuousBatcher(tp, tc, **ENGINE, kv_int8=True,
                                     prefix_cache=prefix_cache, device="cpu",
                                     debug_audit=True)
        for u, p in enumerate(prompts):        # one after the other: warm hit
            b.submit(tserve.Request(uid=u, prompt=p, max_new_tokens=5))
            b.run()
        outs.append({r.uid: r.output.tolist() for r in b.done})
        b.audit()
    assert outs[0] == outs[1]
    assert b.shared_admissions > 0 and b.shared_tokens >= 16


def _motif(n, motif=(3, 7, 11, 5)):
    return np.asarray((list(motif) * (-(-n // len(motif))))[:n], np.int32)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "int8kv"])
def test_spec_on_equals_spec_off(models, kv_int8):
    prompts = [_motif(12 + u) for u in range(3)]
    off, _ = _port(models, "vanilla", prompts, max_new=16, token_budget=16,
                   kv_int8=kv_int8)
    on, b = _port(models, "vanilla", prompts, max_new=16, token_budget=16,
                  kv_int8=kv_int8, spec=tserve.SpecConfig(k=4))
    assert on == off
    assert b.spec_drafted > 0 and b.spec_accepted > 0


@pytest.mark.parametrize("swap", [False, True], ids=["recompute", "swap"])
def test_sampled_preemption_resume_equals_unpreempted(models, swap):
    """Temperature sampling keyed by (seed, position): a preempted row
    resumed by recompute or by swap-in samples the identical tokens."""
    gen = tserve.GenerateConfig(temperature=0.8, top_k=40)
    _, _, tc, tp = models["clipped"]
    prompts = _prompts()
    kw = dict(gen=gen, device="cpu", debug_audit=True, kv_int8=swap,
              swap_break_even_tokens=0 if swap else None)

    def run(preempt_at):
        b = tserve.ContinuousBatcher(tp, tc, **ENGINE, **kw)
        for u, p in enumerate(prompts):
            b.submit(tserve.Request(uid=u, prompt=p, max_new_tokens=8, seed=100 + u))
        ticks = 0
        while b.queue or any(s.req is not None for s in b.slots):
            if ticks == preempt_at:
                b.preempt_slot(next(i for i, s in enumerate(b.slots)
                                    if s.req is not None))
            b.step()
            ticks += 1
        b.audit()
        assert b.allocator.available == b.num_blocks
        return {r.uid: r.output.tolist() for r in b.done}

    base = run(preempt_at=-1)
    assert run(preempt_at=5) == base
    assert run(preempt_at=9) == base
    assert len({tuple(v) for v in base.values()}) == len(base)


def test_sampling_is_a_pure_function_of_seed_and_position():
    logits = torch.randn(3, 50)
    gen = tserve.GenerateConfig(temperature=1.0)
    keys = torch.tensor([7, 7, 8])
    pos = torch.tensor([4, 4, 4])
    a = tserve.sample_rows(logits[[0, 0, 0]], gen, keys, pos)
    assert a[0] == a[1]
    draws = torch.stack([tserve.sample_rows(logits[:1].expand(400, 50), gen,
                                            torch.arange(400), torch.zeros(400))])
    assert draws.unique().numel() > 5              # it does sample
    greedy = tserve.sample_rows(logits, tserve.GenerateConfig(), keys, pos)
    assert torch.equal(greedy, logits.argmax(-1))


def test_refuses_what_this_slice_does_not_port(models):
    _, _, tc, tp = models["vanilla"]
    # xLSTM blocks and W8A8 of ring/recurrent configs are served
    # (tests/test_torch_xlstm_serving.py, tests/test_torch_recurrent_w8a8.py)
    # an embeds config has no token path to serve
    with pytest.raises(ValueError, match="no token path"):
        tserve.ContinuousBatcher(tp, dataclasses.replace(tc, input_kind="embeds"),
                                 batch_size=2, max_len=64, device="cpu")
    # the reference's own refusals of the dense cache
    for kw, match in ((dict(kv_int8=True), "kv_int8 requires paged=True"),
                      (dict(prefix_cache=True), "prefix_cache=True requires paged=True")):
        with pytest.raises(ValueError, match=match):
            tserve.ContinuousBatcher(tp, tc, batch_size=2, max_len=64, paged=False,
                                     device="cpu", **kw)


def test_entry_points_default_to_cuda(models):
    _, _, tc, tp = models["vanilla"]
    calls = [lambda: tserve.ContinuousBatcher(tp, tc, batch_size=2, max_len=64),
             lambda: tserve.ContinuousBatcher(tp, tc, batch_size=2, max_len=64,
                                               qconfig=tqc.QConfig()),
             lambda: ttr.init_paged_cache(tc, 2, 64, 8),
             lambda: ttr.init_cache(tc, 2, 64),
             lambda: ttr.model_init(0, tc)]
    for call in calls:
        if torch.cuda.is_available():
            assert call() is not None
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    # attach_int8_weights takes no device: the int8 leaves follow the params
    attached = tw8.attach_int8_weights(tp)
    assert all(t.device == torch.device("cpu") for t in
               (attached["layers"][0]["b0"]["q"]["w_q8"],
                attached["layers"][0]["b0"]["q"]["w_scale"]))
