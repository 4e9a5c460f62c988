"""The paper's own models (BERT, OPT) in the port against the JAX package,
on the CPU, in float32.

``repro_torch.configs.paper_models`` against ``repro.configs.paper_models``
(fields and what ``check_supported`` accepts: every config, ViT-S/16's
patch-embedding input among them); the learned position
table (``positional_embedding_apply``, bitwise, with the reference's
``jnp.take`` fill: an index outside the table gives a NaN row); one
post-LN block (BERT's, ``attn_layer_out`` taken after ``ln1``); whole-model
logits of ``bert_tiny`` (MLM encoder, non-causal, gelu) and ``opt_tiny``
(CLM decoder, pre-LN, relu) for vanilla, clipped (alpha 4) and gated
attention at atol 1e-4, cache-free and, for OPT, over dense and paged
caches at shared and per-row positions, including a padded tail past
``max_seq_len`` (NaN rows in the same places); the evaluation path
(``evaluate``, ``calibrate``, ``evaluate_perplexity``) at the tolerances
of ``tests/test_torch_eval.py``; and ``ContinuousBatcher`` greedy tokens
on ``opt_tiny`` at ``max_seq_len`` 64, paged and dense, fp and W8A8,
bitwise the reference batcher's, with a tick whose padding runs past the
position table. The Dh-32 route of the flash wrapper is checked without
a card (``route`` and the launch arguments)."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jpm
from repro.configs.base import apply_method as japply
from repro_torch.configs import paper_models as tpm
from repro_torch.configs.base import apply_method as tapply
from repro_torch.convert import from_jax_params

jtr = importlib.import_module("repro.models.transformer")
ttr = importlib.import_module("repro_torch.models.transformer")
jlay = importlib.import_module("repro.nn.layers")
tlay = importlib.import_module("repro_torch.nn.layers")
jserve = importlib.import_module("repro.serving")
tserve = importlib.import_module("repro_torch.serving")
jsyn = importlib.import_module("repro.data.synthetic")
tsyn = importlib.import_module("repro_torch.data.synthetic")
jloss = importlib.import_module("repro.train.losses")
tloss = importlib.import_module("repro_torch.train.losses")
jstep = importlib.import_module("repro.train.step")
tstep = importlib.import_module("repro_torch.train.step")
jloop = importlib.import_module("repro.train.loop")
tloop = importlib.import_module("repro_torch.train.loop")
jptq = importlib.import_module("repro.quant.ptq")
tptq = importlib.import_module("repro_torch.quant.ptq")
jqc = importlib.import_module("repro.quant.qconfig")
tqc = importlib.import_module("repro_torch.quant.qconfig")
tfa = importlib.import_module("repro_torch.kernels.flash_attention")

METHODS = {"vanilla": ("vanilla", {}), "clipped": ("clipped_softmax", {"alpha": 4.0}),
           "gated": ("gated_attention", {})}
# family -> (config maker, data kind)
FAMILIES = {"bert": ("bert_tiny", "mlm"), "opt": ("opt_tiny", "clm")}
VOCAB, SEQ = 128, 32
ATOL = 1e-4
RTOL = 1e-5            # perplexity and outlier summaries (tests/test_torch_eval.py)
# W8A8 perplexity over 2 batches of 64 tokens. With 4 layers of 512-wide
# MLPs, inputs one f32 ulp apart move a few activation codes across a
# rounding edge even on one grid, and each such token moves the mean:
# bert_tiny's weights scaled by 1 +- 1e-7 moved the port's own W8A8
# perplexity by 3.4e-4..7.1e-4 (opt_tiny 4e-5..1.1e-4); the port read
# 1.07e-4 (bert vanilla) and 6.0e-4 (bert gated) from the reference. The
# tight check is per token (W8A8_TOKENS_EQUAL): on the reference's ranges
# 95-100 % of the tokens' logits are bitwise the reference's, where a
# misplaced site or range would move every token.
PTQ_RTOL = 1e-3
W8A8_TOKENS_EQUAL = 0.9
RANGE_RTOL = 1e-6
CONFIGS = ("bert_base", "bert_6l", "bert_tiny", "opt_125m", "opt_tiny", "vit_s16")
_MODELS: dict = {}
_jax_apply = jax.jit(jtr.model_apply, static_argnums=(1,))


def _models(family, method, **replace):
    """(jax cfg, jax params, port cfg, port params), built once each."""
    key = (family, method, tuple(sorted(replace.items())))
    if key not in _MODELS:
        maker, _ = FAMILIES[family]
        name, kw = METHODS[method]
        jc = dataclasses.replace(japply(getattr(jpm, maker)(vocab=VOCAB, seq_len=SEQ),
                                        name, **kw), **replace)
        tc = dataclasses.replace(tapply(getattr(tpm, maker)(vocab=VOCAB, seq_len=SEQ),
                                        name, **kw), **replace)
        jp = jtr.model_init(jax.random.PRNGKey(0), jc)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, jp, tc, tp)
    return _MODELS[key]


def _tokens(b, t, seed=1):
    return np.random.default_rng(seed).integers(1, VOCAB, (b, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("maker", CONFIGS)
def test_config_fields_equal_reference(maker):
    j, t = getattr(jpm, maker)(), getattr(tpm, maker)()
    skip = {"softmax_cfg", "gate_cfg", "moe", "rglru", "xlstm", "param_dtype",
            "compute_dtype"}
    for f in dataclasses.fields(t):
        if f.name not in skip:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for f in ("param_dtype", "compute_dtype"):
        assert str(getattr(t, f)).replace("torch.", "") == jnp.dtype(getattr(j, f)).name
    assert (t.init_std, t.scan_layers) == (j.init_std, False)


@pytest.mark.parametrize("maker", CONFIGS)
def test_check_supported_paper_configs(maker):
    ttr.check_supported(getattr(tpm, maker)())


def test_entry_points_default_to_cuda():
    _, _, tc, tp = _models("opt", "vanilla")
    calls = [lambda: ttr.model_init(0, tc), lambda: ttr.init_cache(tc, 2, 64),
             lambda: tserve.ContinuousBatcher(tp, tc, batch_size=2, max_len=64)]
    for call in calls:
        if torch.cuda.is_available():
            assert call() is not None
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    tree = ttr.model_init(0, tc, device="cpu")
    assert tuple(tree["pos_embed"]["table"].shape) == (tc.max_seq_len, tc.d_model)
    assert tree["layers"][0]["b0"]["q"]["b"].shape == (tc.d_model,)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_from_jax_params_carries_every_leaf(family):
    """The unrolled ``layers`` tree with ``pos_embed`` and the biased
    linears and layernorms: every leaf, path, dtype and value."""
    _, jp, _, tp = _models(family, "gated")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = list(_leaves(tp))
    assert len(tl) == len(jl)
    paths = [jax.tree_util.keystr(p) for p, _ in jl]
    assert "['pos_embed']['table']" in paths and "['layers'][0]['b0']['o']['b']" in paths
    assert "['layers'][3]['b0']['ln2']['bias']" in paths
    for (path, j), t in zip(jl, tl):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(path))


# ---------------------------------------------------------------------------
# the learned position table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(12,), (3, 12)], ids=["shared", "per-row"])
def test_positional_embedding_apply_fill_bitwise(shape):
    """In range, negative (counted from the end) and out of range (NaN
    rows, as ``jnp.take``'s default fill) indices, bitwise."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((16, 8)).astype(np.float32)
    pos = rng.integers(-20, 24, size=shape).astype(np.int32)
    pos.reshape(-1)[:4] = [0, 15, 16, -17]
    want = np.asarray(jlay.positional_embedding_apply({"table": jnp.asarray(table)},
                                                      jnp.asarray(pos)))
    got = tlay.positional_embedding_apply({"table": torch.from_numpy(table)},
                                          torch.from_numpy(pos).long()).numpy()
    assert np.isnan(want).any() and not np.isnan(want).all()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# one post-LN block, whole models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", list(METHODS))
def test_post_ln_block_matches_reference(method):
    """One BERT block: ln1 after the attention residual, ln2 after the
    MLP's; the attention-layer output is the value after ln1."""
    jc, jp, tc, tp = _models("bert", method)
    x = np.random.default_rng(2).standard_normal((2, 10, tc.d_model)).astype(np.float32)
    jx, _, ja, _ = jtr._attn_block_apply(jp["layers"][0]["b0"], jnp.asarray(x), jc, "attn",
                                         None, None, 0, jqc.NO_QUANT, "layer_attn0")
    st = ttr._Step(tc, 2, 10, 0, None, torch.device("cpu"), None, None)
    tx, ta = ttr._attn_block_apply(tp["layers"][0]["b0"], torch.from_numpy(x), tc, "attn",
                                   None, st, tqc.NO_QUANT, "layer_attn0")
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    # post-LN: both outputs are layer-normalized rows (mean 0)
    np.testing.assert_allclose(ta.mean(-1).numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_logits_match_reference(family, method):
    """Cache-free forward with the attention-layer outputs."""
    jc, jp, tc, tp = _models(family, method)
    tokens = _tokens(2, 24, seed=3)
    jl, jaux = jtr.model_apply(jp, jc, {"tokens": jnp.asarray(tokens)}, collect_acts=True)
    tl, taux = ttr.model_apply(tp, tc, {"tokens": torch.from_numpy(tokens)},
                               collect_acts=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert len(taux["attn_outputs"]) == len(jaux["attn_outputs"]) == tc.n_layers
    for a, b in zip(taux["attn_outputs"], jaux["attn_outputs"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


def _same_with_nan(got, want):
    """Equal NaN rows, and the rest within ATOL."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, equal_nan=True)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cached_logits_match_reference_past_the_table(layout):
    """opt_tiny at max_seq_len 64 (clipped): a shared-pos prefill (dense)
    or per-row chunk (paged), then per-row chunks whose padded tails run
    past position 63 with active masks: the padding reads NaN rows of the
    position table in both packages, and its dropped writes keep every
    live row finite and equal."""
    jc, jp, tc, tp = _models("opt", "clipped", max_seq_len=64)
    tokens = _tokens(2, 8, seed=7)
    if layout == "dense":
        jcache, tcache = jtr.init_cache(jc, 2, 64), ttr.init_cache(tc, 2, 64, device="cpu")
    else:
        jcache = jtr.init_paged_cache(jc, 2, 64, 10, 16)
        tcache = ttr.init_paged_cache(tc, 2, 64, 10, 16, device="cpu")
        table = np.array([[3, 1, 7, 5], [0, 2, 4, 9]], np.int32)
        for jl_, tl_ in zip(jcache["layers"], tcache["layers"]):
            jl_["b0"]["block_table"] = jnp.asarray(table)
            tl_["b0"]["block_table"] = torch.from_numpy(table)

    def step(tok, pos, active=None):
        nonlocal jcache, tcache
        jl, jaux = _jax_apply(jp, jc, {"tokens": jnp.asarray(tok)}, cache=jcache,
                              pos=jnp.asarray(pos) if np.ndim(pos) else pos,
                              active=None if active is None else jnp.asarray(active))
        tl, taux = ttr.model_apply(tp, tc, {"tokens": torch.from_numpy(tok)}, cache=tcache,
                                   pos=torch.from_numpy(pos) if np.ndim(pos) else pos,
                                   active=None if active is None else torch.from_numpy(active))
        _same_with_nan(tl.numpy(), np.asarray(jl))
        jcache, tcache = jaux["cache"], taux["cache"]
        return tl

    if layout == "dense":
        step(tokens, 0)
    else:
        step(tokens, np.array([0, 0], np.int32))
    # row 0 decodes at 60 inside a tick of 8 (positions 60..67), row 1
    # writes a 5-token chunk at 8
    act = np.zeros((2, 8), bool)
    act[0, 0], act[1, :5] = True, True
    out = step(tokens, np.array([60, 8], np.int32), act)
    assert torch.isnan(out[0, 4:]).all() and torch.isfinite(out[0, :4]).all()
    assert torch.isfinite(out[1]).all()
    step(tokens[:, :1], np.array([61, 13], np.int32), np.array([True, True]))
    for j, t in zip(jax.tree_util.tree_leaves(jcache), _leaves(tcache)):
        assert torch.isfinite(t.float()).all()
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   atol=1e-5, rtol=0)


def _leaves(tree):
    """Leaves in ``jax.tree_util``'s order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# the evaluation path
# ---------------------------------------------------------------------------
def _data(pkg):
    return pkg.SyntheticLM(pkg.SyntheticLMConfig(vocab_size=VOCAB, seq_len=SEQ,
                                                 batch_size=2, seed=0))


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_evaluate_matches_reference(family, method):
    jc, jp, tc, tp = _models(family, method)
    kind = FAMILIES[family][1]
    jppl, jst = jloop.evaluate(jstep.TrainTask(cfg=jc), jp, _data(jsyn), 2, kind)
    tppl, tst = tloop.evaluate(tstep.TrainTask(cfg=tc), tp, _data(tsyn), 2, kind)
    np.testing.assert_allclose(tppl, jppl, rtol=RTOL)
    assert tst["max_inf_norm"] > 0 and tst["avg_kurtosis"] > 0
    for key in jst:
        np.testing.assert_allclose(tst[key], jst[key], rtol=RTOL)


def _ptq_fns(pkg_tr, pkg_loss, pkg_qc, cfg, kind, to_batch):
    def apply_fn(p, batch, ctx):
        return pkg_tr.model_apply(p, cfg, batch, ctx=ctx)[0]

    def loss_fn(p, batch, ctx):
        ctx = ctx if ctx is not None else pkg_qc.QuantContext(None)
        logits, _ = pkg_tr.model_apply(p, cfg, batch, ctx=ctx)
        return pkg_loss.loss_for(kind)(logits, batch["labels"])

    def batches(data, start, n):
        return [to_batch(data.batch(start + i, kind)) for i in range(n)]

    return apply_fn, loss_fn, batches


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_calibrate_and_w8a8_perplexity_match_reference(family, method):
    """Calibrated ranges (the layernorm outputs and the biased linears'
    sites, named per pattern index as in the reference, so the four
    layers share one estimator), then the W8A8 fake-quant perplexity."""
    jc, jp, tc, tp = _models(family, method)
    kind = FAMILIES[family][1]
    japp, jlf, jb = _ptq_fns(jtr, jloss, jqc, jc, kind,
                             lambda b: {k: jnp.asarray(v) for k, v in b.items()})
    tapp, tlf, tb = _ptq_fns(ttr, tloss, tqc, tc, kind,
                             lambda b: {k: torch.from_numpy(v) for k, v in b.items()})
    jd, td = _data(jsyn), _data(tsyn)
    jctx = jptq.calibrate(japp, jp, jb(jd, 5_000_000, 3), jqc.QConfig(), num_batches=3)
    tctx = tptq.calibrate(tapp, tp, tb(td, 5_000_000, 3), tqc.QConfig(), num_batches=3)
    assert sorted(tctx.ranges) == sorted(jctx.ranges)
    assert {"layer_attn0/ln1.out", "layer_attn0/ln2.out", "layer_attn0/o.out",
            "layer_attn0/mlp/up.out"} <= set(tctx.ranges)
    assert not any(n.startswith(("layer_attn1", "layer_attn2")) for n in tctx.ranges)
    for name, (lo, hi) in jctx.ranges.items():
        np.testing.assert_allclose([float(v) for v in tctx.ranges[name]],
                                   [float(lo), float(hi)], rtol=RANGE_RTOL, err_msg=name)
    jppl = jptq.evaluate_perplexity(jlf, jp, jb(jd, 10_000_000, 2), jctx)
    tppl = tptq.evaluate_perplexity(tlf, tp, tb(td, 10_000_000, 2), tctx)
    np.testing.assert_allclose(tppl, jppl, rtol=PTQ_RTOL)
    loaded = tqc.QuantContext(tqc.QConfig())
    loaded.load_ranges({n: tuple(torch.tensor(np.asarray(v)) for v in r)
                        for n, r in jctx.ranges.items()})
    # the reference's ranges loaded: the same grid, but the sites' inputs
    # still differ by f32 ulps (see PTQ_RTOL)
    held_out = zip(jb(jd, 10_000_000, 2), tb(td, 10_000_000, 2))
    np.testing.assert_allclose(tptq.evaluate_perplexity(tlf, tp, tb(td, 10_000_000, 2), loaded),
                               jppl, rtol=PTQ_RTOL)
    diff = np.concatenate([np.abs(np.asarray(japp(jp, jbat, jctx)) - tapp(tp, tbat, loaded).numpy())
                           .max(-1).reshape(-1) for jbat, tbat in held_out])
    assert (diff == 0).mean() >= W8A8_TOKENS_EQUAL, (diff == 0).mean()


# ---------------------------------------------------------------------------
# serving opt_tiny
# ---------------------------------------------------------------------------
def _serve(batcher_cls, req_cls, params, cfg, prompts, max_new, **kw):
    b = batcher_cls(params, cfg, batch_size=2, max_len=64, block_size=8,
                    token_budget=16, **kw)
    for u, p in enumerate(prompts):
        b.submit(req_cls(uid=u, prompt=p, max_new_tokens=max_new[u]))
    b.run()
    return {r.uid: r.output.tolist() for r in b.done}, b


@pytest.mark.parametrize("case", ["paged-vanilla", "paged-clipped", "paged-gated",
                                  "dense-vanilla", "dense-gated", "paged-clipped-w8a8"])
def test_batcher_tokens_equal_reference(case):
    """Greedy tokens of four requests over two slots at max_seq_len 64: a
    44-token prompt decodes up to position 59 while the other slot's
    second occupant prefills in chunks of up to 16, so a tick's padded
    tail runs past the position table (checked on the port's ticks)."""
    paged = case.startswith("paged")
    method = case.split("-")[1]
    jc, jp, tc, tp = _models("opt", method, max_seq_len=64)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, VOCAB, size=n).astype(np.int32) for n in (44, 5, 19, 11)]
    max_new = [16, 3, 8, 6]
    kw = dict(paged=paged)
    if case.endswith("w8a8"):
        kw.update(qconfig=jqc.QConfig())
    ref, _ = _serve(jserve.ContinuousBatcher, jserve.Request, jp, jc, prompts, max_new, **kw)
    if case.endswith("w8a8"):
        kw.update(qconfig=tqc.QConfig())
    reach = []
    b = tserve.ContinuousBatcher(tp, tc, batch_size=2, max_len=64, block_size=8,
                                 token_budget=16, device="cpu", debug_audit=True, **kw)
    step_fn = b._step_fn

    def watch(params, cache, tokens, pos, counts, *rest):
        reach.append(int(pos.max()) + tokens.shape[1])
        return step_fn(params, cache, tokens, pos, counts, *rest)

    b._step_fn = watch
    for u, p in enumerate(prompts):
        b.submit(tserve.Request(uid=u, prompt=p, max_new_tokens=max_new[u]))
    b.run()
    out = {r.uid: r.output.tolist() for r in b.done}
    assert out == ref
    assert [len(out[u]) for u in range(4)] == max_new and not b.failed
    assert max(reach) > tc.max_seq_len, reach
    if paged:
        b.audit()
        assert b.allocator.available == b.num_blocks


# ---------------------------------------------------------------------------
# the flash wrapper at Dh 32, without a card
# ---------------------------------------------------------------------------
def test_flash_dh32_routes_and_launch_arguments(monkeypatch):
    """Dh 32 is a head dim the CUDA wrapper takes: bf16 goes to the
    tensor-core route (route 1), f32 to the CUDA-core route (route 0);
    Dh 48 is refused. Checked through ``_launch`` with the library, the
    device guard and the stream stood in (this machine has no card)."""
    assert 32 in tfa._HEAD_DIMS
    assert tfa.route(torch.bfloat16, 32) == "tensor-core"
    assert tfa.route(torch.float32, 32) == "cuda-core"
    calls = []

    class Lib:
        def flash_attention_launch(self, *args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tfa, "_kernel_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())

    class Guard:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", lambda dev: Guard())
    for dtype, want_route in ((torch.bfloat16, 1), (torch.float32, 0)):
        q = torch.zeros(2, 8, 4, 32, dtype=dtype)
        kv = torch.zeros(2, 8, 4, 32, dtype=dtype)
        launches = tfa.launches
        out = tfa._launch(q, kv, kv, None, 0, False, None, None, 0.0, 1.0)
        assert out.shape == q.shape and tfa.launches == launches + 1
        args = calls[-1]
        assert args[11] == 32                      # Dh
        assert args[-2] == want_route and args[-3] == tfa._DTYPE_CODE[dtype]
        assert args[28] == 0                       # causal off (BERT)
    with pytest.raises(ValueError, match="head dim 48"):
        q = torch.zeros(1, 8, 2, 48, dtype=torch.bfloat16)
        tfa._launch(q, q, q, None, 0, True, None, None, 0.0, 1.0)
