"""W8A8 serving and the evaluation path of recurrentgemma-smoke (griffin,
griffin, local_attn; window 8; a 2-block griffin tail) in the port
against the JAX package, on the CPU, on converted reference weights:

  * (the reference's ``int8_matmul`` runs as its source reads, the
    Pallas product as one exact integer ``jnp.dot``:
    ``tests/test_torch_xlstm_serving.py``'s ``_int8_matmul_as_written``)
  * ``ContinuousBatcher(qconfig=QConfig())``, paged under the clipped
    softmax (alpha 4; ``kv_int8`` defaults on, as in the reference, with
    no global pool to quantize) and dense under gated attention, at token
    budget 8 (prompts past the window run in chunks): the engine's
    calibration (``_calibrate_engine``: threefry tokens, the unrolled
    layers, site names repeated across groups) has the reference's sites,
    every Griffin site (``in_gate``, ``in_x``, ``rglru/w_a``,
    ``rglru/w_x``, ``merged``, ``out``) among them, and its (s, z) equal up
    to the fp forward's f32 rounding (rtol 1e-5); its greedy tokens equal
    the reference batcher's; the paged engine audits clean;
  * the cache after W8A8 ticks of a bfloat16 model: the int8 GEMMs return
    f32, so the reference's conv histories turn f32 while the ring stays
    bfloat16; every leaf's dtype is the reference's, the ring K/V, its
    position ids and the conv histories bitwise, the recurrent h (the
    reference's associative scan against the port's sequential one) at
    atol 1e-5, after a chunk that fills the ring, a chunk that wraps it,
    a decode tick, and a second occupant of the slot;
  * the evaluation path: ``evaluate`` (FP perplexity, max inf-norm,
    kurtosis, rtol 1e-5), ``calibrate`` and ``evaluate_perplexity``
    (W8A8 fake-quant perplexity, rtol 1e-3), under the clipped softmax."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import apply_method as japply
from repro.configs.base import to_bf16 as jbf16
from repro.configs.recurrentgemma_9b import smoke as jsmoke
from repro_torch.configs.base import apply_method as tapply
from repro_torch.configs.base import to_bf16 as tbf16
from repro_torch.configs.recurrentgemma_9b import smoke as tsmoke
from repro_torch.convert import from_jax_params
from repro_torch.nn.module import flatten_params
from test_torch_xlstm_serving import _int8_matmul_as_written
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

jtr = importlib.import_module("repro.models.transformer")
ttr = importlib.import_module("repro_torch.models.transformer")
jserve = importlib.import_module("repro.serving")
tserve = importlib.import_module("repro_torch.serving")
jsched = importlib.import_module("repro.serving.scheduler")
tsched = importlib.import_module("repro_torch.serving.scheduler")
jqc = importlib.import_module("repro.quant.qconfig")
jint8 = importlib.import_module("repro.kernels.int8_matmul")
tqc = importlib.import_module("repro_torch.quant.qconfig")
jptq = importlib.import_module("repro.quant.ptq")
tptq = importlib.import_module("repro_torch.quant.ptq")
jloop = importlib.import_module("repro.train.loop")
tloop = importlib.import_module("repro_torch.train.loop")
jstep = importlib.import_module("repro.train.step")
tstep = importlib.import_module("repro_torch.train.step")
jloss = importlib.import_module("repro.train.losses")
tloss = importlib.import_module("repro_torch.train.losses")
jsyn = importlib.import_module("repro.data.synthetic")
tsyn = importlib.import_module("repro_torch.data.synthetic")

METHODS = {"clipped": ("clipped_softmax", {"alpha": 4.0}), "gated": ("gated_attention", {})}
GRIFFIN_SITES = ("in_gate", "in_x", "rglru/w_a", "rglru/w_x", "merged", "out")
RTOL = 1e-5
PTQ_RTOL = 1e-3
H_ATOL = 1e-5
# one block a row: recurrentgemma has no global pool, and a single table
# width keeps the reference's paged tick to one program per chunk length;
# one calibration batch: the reference calibrates op by op
ENGINE = dict(batch_size=2, max_len=32, block_size=32, token_budget=8, calib_batches=1)
_MODELS: dict = {}


def _models(method, bf16=False):
    key = (method, bf16)
    if key not in _MODELS:
        name, kw = METHODS[method]
        jc, tc = japply(jsmoke(), name, **kw), tapply(tsmoke(), name, **kw)
        if bf16:
            jc, tc = jbf16(jc), tbf16(tc)
        jp = jtr.model_init(jax.random.PRNGKey(0), jc)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, jp, tc, tp)
    return _MODELS[key]


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(1, 120, size=n).astype(np.int32) for n in (8, 20, 13)]


def _serve(pkg, params, cfg, paged, **kw):
    b = pkg.ContinuousBatcher(params, cfg, paged=paged, qconfig=pkg_qc(pkg).QConfig(),
                              **ENGINE, **kw)
    for u, p in enumerate(_prompts()):
        b.submit(pkg.Request(uid=u, prompt=p, max_new_tokens=4))
    b.run()
    assert not b.failed
    return {r.uid: r.output.tolist() for r in b.done}, b


def pkg_qc(pkg):
    return jqc if pkg is jserve else tqc


@pytest.mark.parametrize("method,paged", [("clipped", True), ("gated", False)],
                         ids=["clipped-paged", "gated-dense"])
def test_w8a8_batcher_calibration_and_tokens_equal_reference(method, paged, monkeypatch):
    jc, jp, tc, tp = _models(method)
    monkeypatch.setattr(jint8, "int8_matmul", _int8_matmul_as_written)
    ref, jb = _serve(jserve, jp, jc, paged)
    got, b = _serve(tserve, tp, tc, paged, device="cpu", debug_audit=paged)
    # each engine's own calibration: the same sites, one per pattern index
    # (the groups fold into it), every Griffin site among them, and (s, z)
    # equal up to the fp forward's f32 rounding
    jq, tq = jb._qctx._act_qp, b._qctx._act_qp
    assert sorted(tq) == sorted(jq)
    for prefix in ("layer_griffin0", "layer_griffin1", "tail_griffin0", "tail_griffin1"):
        assert {f"{prefix}/griffin/{s}" + ("" if s == "merged" else ".in")
                for s in GRIFFIN_SITES} <= set(tq), prefix
    assert "layer_local_attn2/q.in" in tq
    assert not any(s.startswith("layer_griffin3") for s in tq)
    for name, (s, z) in jq.items():
        np.testing.assert_allclose(tq[name][0], s, rtol=RTOL, err_msg=name)
        assert abs(tq[name][1] - z) <= 1, name
    assert got == ref
    assert b.kv_int8 == jb.kv_int8 == paged
    assert b._chunk_cap == 8
    if paged:
        assert not list(ttr.paged_entries(b.cache))
        b.audit()
        assert b.allocator.available == b.num_blocks and (b.tables == -1).all()


def _leaves(cache):
    return {path: leaf for path, leaf in flatten_params(cache)
            if not path.endswith("block_table")}


def test_w8a8_tick_cache_dtypes_and_bits_equal_reference(monkeypatch):
    """A bfloat16 model, a dense engine: the reference's ranges are loaded
    into the port's engine, so both quantize on one grid."""
    jc, jp, tc, tp = _models("clipped", bf16=True)
    monkeypatch.setattr(jint8, "int8_matmul", _int8_matmul_as_written)
    jb = jserve.ContinuousBatcher(jp, jc, paged=False, qconfig=jqc.QConfig(), **ENGINE)

    def reference_ranges(*_):
        ctx = tqc.QuantContext(tqc.QConfig())
        ctx.load_ranges({n: tuple(torch.from_numpy(np.array(v)) for v in r)
                         for n, r in jb._qctx.ranges.items()})
        ctx.use_int8_runtime()
        return ctx

    monkeypatch.setattr(tsched, "_calibrate_engine", reference_ranges)
    tb = tserve.ContinuousBatcher(tp, tc, paged=False, qconfig=tqc.QConfig(), device="cpu",
                                  **ENGINE)
    prompts = [np.arange(1, 13, dtype=np.int32), np.arange(40, 45, dtype=np.int32)]
    for b, pkg in ((jb, jserve), (tb, tserve)):
        b.submit(pkg.Request(uid=0, prompt=prompts[0], max_new_tokens=2))
    converted = {"h": 0, "conv": 0}
    for tick in range(5):
        if tick == 3:       # the slot's second occupant: its rows reset
            for b, pkg in ((jb, jserve), (tb, tserve)):
                b.submit(pkg.Request(uid=1, prompt=prompts[1], max_new_tokens=2))
        jb.step()
        tb.step()
        want = {p: np.asarray(jnp.asarray(x, jnp.float32)) for p, x in
                _leaves(jax.tree_util.tree_map(np.asarray, jb.cache)).items()}
        wdt = {p: str(x.dtype) for p, x in _leaves(jax.tree_util.tree_map(np.asarray,
                                                                         jb.cache)).items()}
        got = _leaves(tb.cache)
        assert sorted(got) == sorted(want)
        for path, x in got.items():
            assert str(x.dtype).replace("torch.", "") == wdt[path], (tick, path)
            g = x.float().numpy()
            if path.endswith("/h"):
                np.testing.assert_allclose(g, want[path], atol=H_ATOL, rtol=0,
                                           err_msg=f"{tick} {path}")
                converted["h"] += 1
            else:
                np.testing.assert_array_equal(g, want[path], err_msg=f"{tick} {path}")
                converted["conv"] += path.endswith("/conv")
        conv_dtypes = {str(x.dtype) for p, x in got.items() if p.endswith("/conv")}
        ring_dtypes = {str(x.dtype) for p, x in got.items() if p.endswith(("/k", "/v"))}
        assert conv_dtypes == {"torch.float32"} and ring_dtypes == {"torch.bfloat16"}
    assert converted["h"] and converted["conv"]
    assert {r.uid: r.output.tolist() for r in tb.done} == \
        {r.uid: r.output.tolist() for r in jb.done}


def _data(pkg):
    return pkg.SyntheticLM(pkg.SyntheticLMConfig(vocab_size=128, seq_len=24, batch_size=2,
                                                 seed=0))


def test_evaluation_path_matches_reference():
    jc, jp, tc, tp = _models("clipped")
    jppl, jst = jloop.evaluate(jstep.TrainTask(cfg=jc), jp, _data(jsyn), 2, "clm")
    tppl, tst = tloop.evaluate(tstep.TrainTask(cfg=tc), tp, _data(tsyn), 2, "clm")
    np.testing.assert_allclose(tppl, jppl, rtol=RTOL)
    assert tst["max_inf_norm"] > 0 and tst["avg_kurtosis"] > 0
    for key in jst:
        np.testing.assert_allclose(tst[key], jst[key], rtol=RTOL)

    def fns(tr, loss, qc, cfg, to_batch, data):
        def apply_fn(p, b, ctx):
            return tr.model_apply(p, cfg, b, ctx=ctx)[0]

        def loss_fn(p, b, ctx):
            ctx = ctx if ctx is not None else qc.QuantContext(None)
            return loss.loss_for("clm")(tr.model_apply(p, cfg, b, ctx=ctx)[0], b["labels"])

        return apply_fn, loss_fn, lambda start, n: [
            to_batch(data.batch(start + i, "clm")) for i in range(n)]

    japp, jlf, jb = fns(jtr, jloss, jqc, jc, lambda b: {k: jnp.asarray(v) for k, v in b.items()},
                        _data(jsyn))
    tapp, tlf, tb = fns(ttr, tloss, tqc, tc,
                        lambda b: {k: torch.from_numpy(v) for k, v in b.items()}, _data(tsyn))
    jctx = jptq.calibrate(japp, jp, jb(5_000_000, 2), jqc.QConfig(), num_batches=2)
    tctx = tptq.calibrate(tapp, tp, tb(5_000_000, 2), tqc.QConfig(), num_batches=2)
    assert sorted(tctx.ranges) == sorted(jctx.ranges)
    assert {"layer_griffin0/griffin/merged", "tail_griffin1/griffin/in_x.in",
            "layer_local_attn2/attn.out"} <= set(tctx.ranges)
    for name, (lo, hi) in jctx.ranges.items():
        np.testing.assert_allclose([float(v) for v in tctx.ranges[name]],
                                   [float(lo), float(hi)], rtol=RTOL, atol=1e-6, err_msg=name)
    jq = jptq.evaluate_perplexity(jlf, jp, jb(10_000_000, 2), jctx)
    tq = tptq.evaluate_perplexity(tlf, tp, tb(10_000_000, 2), tctx)
    np.testing.assert_allclose(tq, jq, rtol=PTQ_RTOL)
