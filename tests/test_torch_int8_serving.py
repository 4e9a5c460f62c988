"""The port's W8A8 serving path against the JAX package's, on the CPU.

``repro_torch.serving.ContinuousBatcher(qconfig=QConfig(), device="cpu")``
and the reference ``repro.serving.ContinuousBatcher(qconfig=QConfig())``
get the same converted qwen3 smoke weights and the same requests. Each
engine calibrates on its own synthetic tokens, which the port draws with
its threefry (``repro_torch.random``) bit for bit as the reference draws
them with ``jax.random``, so both calibrate on the same data under the
default calibration, nothing substituted. Greedy tokens must be equal for
vanilla, clipped (alpha = 4) and gated attention with int8 KV on (the
default under ``qconfig``) and off, with speculation and with the prefix
cache. On the CPU every int8 linear runs the kernel's plain version.

Below the engine: the collect-mode site names equal the reference's
(names repeat across layers: 22 activation sites, 7 of them linear
inputs, for 2-layer qwen3-smoke), and ``model_apply`` in int8 mode with
the reference's ranges loaded matches the reference's logits."""
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

jtr = importlib.import_module("repro.models.transformer")
jserve = importlib.import_module("repro.serving")
jsched = importlib.import_module("repro.serving.scheduler")
jqc = importlib.import_module("repro.quant.qconfig")
jw8 = importlib.import_module("repro.quant.int8_weights")
ttr = importlib.import_module("repro_torch.models.transformer")
tserve = importlib.import_module("repro_torch.serving")
tqc = importlib.import_module("repro_torch.quant.qconfig")
tw8 = importlib.import_module("repro_torch.quant.int8_weights")
tim = importlib.import_module("repro_torch.kernels.int8_matmul")

METHODS = {"vanilla": ("vanilla", {}), "clipped": ("clipped_softmax", {"alpha": 4.0}),
           "gated": ("gated_attention", {})}
ENGINE = dict(batch_size=2, max_len=64, paged=True, block_size=16, token_budget=8)


def _configs(method, dtype="float32"):
    name, kw = METHODS[method]
    jc, tc = japply(jsmoke(), name, **kw), tapply(tsmoke(), name, **kw)
    if dtype == "bfloat16":
        jc = dataclasses.replace(jc, param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    return jc, tc


def _weights(jc, tc, seed=0):
    jp = jtr.model_init(jax.random.PRNGKey(seed), jc)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def models():
    """Per method: (jax cfg, jax params, port cfg, port params), f32."""
    out = {}
    for m in METHODS:
        jc, tc = _configs(m)
        out[m] = (jc, tc) + _weights(jc, tc)
    return {m: (v[0], v[2], v[1], v[3]) for m, v in out.items()}


def _reference_tokens(cfg, t, n, device):
    """The reference engine's calibration batches (``_calibrate_engine``)."""
    key = jax.random.PRNGKey(0)
    return [{"tokens": torch.from_numpy(np.array(jax.random.randint(
        jax.random.fold_in(key, i), (2, t), 0, cfg.vocab_size))).long().to(device)}
        for i in range(n)]


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 120, size=n).astype(np.int32) for n in (5, 19)]


def _run(batcher_cls, req_cls, params, cfg, prompts, max_new=6, **kw):
    b = batcher_cls(params, cfg, **{**ENGINE, **kw})
    for u, p in enumerate(prompts):
        b.submit(req_cls(uid=u, prompt=p, max_new_tokens=max_new))
    b.run()
    return {r.uid: r.output.tolist() for r in b.done}, b


def _both(jp, jc, tp, tc, prompts, max_new=6, **kw):
    """Reference and port W8A8 engines on the same requests; the port's
    audit and block-leak checks run after."""
    ref, _ = _run(jserve.ContinuousBatcher, jserve.Request, jp, jc, prompts, max_new,
                  qconfig=jqc.QConfig(), **kw)
    launches = tim.launches
    out, b = _run(tserve.ContinuousBatcher, tserve.Request, tp, tc, prompts, max_new,
                  qconfig=tqc.QConfig(), device="cpu", debug_audit=True, **kw)
    assert tim.launches == launches               # CPU tensors: the plain version
    b.audit()
    assert b.allocator.available == b.num_blocks and (b.tables == -1).all()
    return ref, out, b


@pytest.mark.parametrize("kv_int8", [None, False], ids=["int8kv-default", "fpkv"])
@pytest.mark.parametrize("method", list(METHODS))
def test_w8a8_greedy_tokens_equal_reference_batcher(models, method,
                                                    kv_int8):
    jc, jp, tc, tp = models[method]
    ref, out, b = _both(jp, jc, tp, tc, _prompts(), kv_int8=kv_int8)
    assert out == ref
    assert len(out) == 2 and all(len(v) == 6 for v in out.values())
    assert b.kv_int8 is (kv_int8 is None)          # on by default under qconfig
    assert b._qctx.mode == "int8" and not b.cfg.scan_layers


def _motif(n, motif=(3, 7, 11, 5)):
    return np.asarray((list(motif) * (-(-n // len(motif))))[:n], np.int32)


def test_w8a8_with_speculation_equals_reference(models):
    jc, jp, tc, tp = models["vanilla"]
    prompts = [_motif(12 + u) for u in range(3)]
    ref, out, b = _both(jp, jc, tp, tc, prompts, max_new=16, token_budget=16,
                        spec=tserve.SpecConfig(k=4))
    assert out == ref
    assert b.spec_drafted > 0 and b.spec_accepted > 0


def test_w8a8_with_prefix_cache_equals_reference(models):
    jc, jp, tc, tp = models["gated"]
    rng = np.random.default_rng(9)
    shared = rng.integers(1, 120, size=19).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 120, size=n).astype(np.int32)])
               for n in (3, 6)]
    outs = []
    for batcher, req, p, c, kw in (
            (jserve.ContinuousBatcher, jserve.Request, jp, jc, dict(qconfig=jqc.QConfig())),
            (tserve.ContinuousBatcher, tserve.Request, tp, tc,
             dict(qconfig=tqc.QConfig(), device="cpu", debug_audit=True))):
        b = batcher(p, c, **ENGINE, prefix_cache=True, **kw)
        for u, pr in enumerate(prompts):        # one after the other: a warm hit
            b.submit(req(uid=u, prompt=pr, max_new_tokens=5))
            b.run()
        outs.append({r.uid: r.output.tolist() for r in b.done})
    assert outs[0] == outs[1]
    b.audit()
    assert b.shared_admissions > 0


def test_w8a8_f32_queries_over_bf16_pool(monkeypatch):
    """bf16 weights, int8 KV off: the W8A8 projections return f32, so the
    tick's paged read gets f32 queries over a bf16 pool through the
    dispatcher, in the port as in the reference."""
    jc, tc = _configs("clipped", "bfloat16")
    jp, tp = _weights(jc, tc)
    seen = []
    dispatch = ttr.paged_attention

    def spy(q, k_pool, *a, **kw):
        seen.append((q.dtype, k_pool.dtype))
        return dispatch(q, k_pool, *a, **kw)
    monkeypatch.setattr(ttr, "paged_attention", spy)
    ref, out, _ = _both(jp, jc, tp, tc, _prompts(), kv_int8=False)
    assert out == ref
    assert seen and set(seen) == {(torch.float32, torch.bfloat16)}


def test_w8a8_tick_reads_no_scalar_back(models, monkeypatch):
    """Calibration leaves every range a python float: the serving tick
    never reads a scalar from a tensor (on the card each read is a host
    sync, 280 of them per qwen3-14b forward)."""
    jc, jp, tc, tp = models["gated"]
    b = tserve.ContinuousBatcher(tp, tc, **ENGINE, qconfig=tqc.QConfig(), device="cpu")
    qp = [b._qctx.act_qparams(n) for n in b._qctx.ranges if n.endswith(".in")]
    assert qp and all(isinstance(v, float) for pair in qp for v in pair)

    def refuse(self, *a, **kw):
        raise AssertionError("a scalar was read back inside the tick")
    for name in ("item", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for u, p in enumerate(_prompts()):
        b.submit(tserve.Request(uid=u, prompt=p, max_new_tokens=4))
    b.run()
    assert len(b.done) == 2


# ---------------------------------------------------------------------------
# below the engine: sites and whole-model logits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["clipped", "gated"])
def test_collect_site_names_equal_reference(models, method):
    jc, jp, tc, tp = models[method]
    jcfg = dataclasses.replace(jc, scan_layers=False)
    tokens = _reference_tokens(jc, 32, 2, "cpu")
    jctx = jqc.QuantContext(jqc.QConfig(), "collect")
    tctx = tqc.QuantContext(tqc.QConfig(), "collect")
    for batch in tokens:
        jtr.model_apply(jp, jcfg, {"tokens": jnp.asarray(batch["tokens"].numpy())}, ctx=jctx)
        ttr.model_apply(tp, tc, batch, ctx=tctx)
    jctx.finalize()
    tctx.finalize()
    assert sorted(tctx.ranges) == sorted(jctx.ranges)
    acts = [n for n in tctx.ranges if not n.endswith("#w")]
    assert len(acts) == 22                          # one site per kind, all layers
    assert sorted(n for n in acts if n.endswith(".in")) == sorted(
        f"layer_attn0/{s}.in" for s in ("q", "k", "v", "o", "mlp/gate", "mlp/up", "mlp/down"))
    # same estimators over the same tokens; the fp forward rounds differently
    for n, (lo, hi) in jctx.ranges.items():
        np.testing.assert_allclose([float(v) for v in tctx.ranges[n]],
                                   [float(lo), float(hi)], rtol=1e-5, atol=1e-6)


def _int8_ctx_from_reference(jc, jp):
    jctx = jsched._calibrate_engine(jp, jc, jqc.QConfig(), 64, 4)
    tctx = tqc.QuantContext(tqc.QConfig())
    tctx.load_ranges({n: (torch.from_numpy(np.array(lo)), torch.from_numpy(np.array(hi)))
                      for n, (lo, hi) in jctx.ranges.items()})
    tctx.use_int8_runtime()
    return jctx, tctx


# int8 mode: the linears are exact integer products on equal codes, so the
# packages differ only by the f32 rounding around them (norms, attention,
# the f32 head). In the bf16 config only the embedding and the first norm
# are bf16 (its first projections return f32), so it too is held at f32
# rounding; its method is the clipped softmax, because the gate's bf16
# einsum rounds once in XLA's fused f32 and per op in torch.
LOGIT_ATOL = 1e-5


@pytest.mark.parametrize("dtype,method", [("float32", "gated"), ("bfloat16", "clipped")])
def test_int8_model_apply_matches_reference_logits(dtype, method):
    jc, tc = _configs(method, dtype)
    jp, tp = _weights(jc, tc, seed=1)
    jctx, tctx = _int8_ctx_from_reference(jc, jp)
    for n in tctx.ranges:
        assert tctx.act_qparams(n) == jctx.act_qparams(n)
    ja, ta = jw8.attach_int8_weights(jp), tw8.attach_int8_weights(tp)
    japply_int8 = jax.jit(lambda p, b, **kw: jtr.model_apply(p, jc, b, ctx=jctx, **kw))
    tokens = np.random.default_rng(7).integers(0, 128, (2, 6))
    jl, _ = japply_int8(ja, {"tokens": jnp.asarray(tokens)})
    tl, _ = ttr.model_apply(ta, tc, {"tokens": torch.from_numpy(tokens)}, ctx=tctx)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), atol=LOGIT_ATOL, rtol=0)
    # the same over a paged cache: a prefill chunk, then a decode step
    table = np.array([[3, 1, -1, -1], [0, 2, 4, -1]], np.int32)
    jcache = jtr.init_paged_cache(jc, 2, 32, 6, 8, kv_int8=True)
    tcache = ttr.init_paged_cache(tc, 2, 32, 6, 8, kv_int8=True, device="cpu")
    for jl_, tl_ in zip(jcache["layers"], tcache["layers"]):
        jl_["b0"]["block_table"] = jnp.asarray(table)
        tl_["b0"]["block_table"] = torch.from_numpy(table)
    pos = np.array([0, 9], np.int32)
    for step in (tokens, tokens[:, :1]):
        jl, jaux = japply_int8(ja, {"tokens": jnp.asarray(step)}, cache=jcache,
                               pos=jnp.asarray(pos))
        tl, taux = ttr.model_apply(ta, tc, {"tokens": torch.from_numpy(step)}, ctx=tctx,
                                   cache=tcache, pos=torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), atol=LOGIT_ATOL,
                                   rtol=0)
        jcache, tcache = jaux["cache"], taux["cache"]
        pos = pos + step.shape[1]
