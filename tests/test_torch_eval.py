"""The paper's evaluation path in the port against the JAX package's, on
the CPU: synthetic data, losses, outlier metrics, FP evaluation
(``train.evaluate``), PTQ calibration + W8A8 fake-quant perplexity
(``quant.calibrate`` / ``evaluate_perplexity``) and the seed sweep
(``quant.ptq_sweep``).

The same converted qwen3-smoke weights (2 layers, unrolled, f32) and the
same numpy batches go through both packages, for vanilla, clipped softmax
(alpha 4) and gated attention. ``SyntheticLM`` batches are bitwise;
losses agree at atol 1e-6 (rtol 1e-6 for sums above 1), infinity norms,
outlier masks and counts exactly, kurtosis at rtol 1e-5 (means of fourth
powers in f32, summed in another order than XLA's); FP perplexity and the
outlier summary at rtol 1e-5. A scanned model reports ``act_stats`` (held
at atol 1e-5) and, as in the reference, no ``attn_outputs``, so its
``OutlierStats`` stay empty.

PTQ: the calibrated ranges agree to rtol 1e-6 (an ulp or two: the two
f32 forwards differ in their last bits), and with the reference's ranges
loaded the port's W8A8 perplexity agrees to rtol 1e-5 (its fake-quant
grid is then the reference's, and its sites bitwise so). End to end, each
package on its own ranges, a range one ulp apart moves every code of its
site's grid and some cross a rounding boundary: the W8A8 perplexity then
moved by up to 7.6e-5 (clipped softmax, second calibration seed of the
sweep) and is held at rtol 2e-4."""
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

jsyn = importlib.import_module("repro.data.synthetic")
tsyn = importlib.import_module("repro_torch.data.synthetic")
jloss = importlib.import_module("repro.train.losses")
tloss = importlib.import_module("repro_torch.train.losses")
jout = importlib.import_module("repro.core.outliers")
tout = importlib.import_module("repro_torch.core.outliers")
jstep = importlib.import_module("repro.train.step")
tstep = importlib.import_module("repro_torch.train.step")
jloop = importlib.import_module("repro.train.loop")
tloop = importlib.import_module("repro_torch.train.loop")
jptq = importlib.import_module("repro.quant.ptq")
tptq = importlib.import_module("repro_torch.quant.ptq")
jqc = importlib.import_module("repro.quant.qconfig")
tqc = importlib.import_module("repro_torch.quant.qconfig")
jtr = importlib.import_module("repro.models.transformer")
ttr = importlib.import_module("repro_torch.models.transformer")
jsched = importlib.import_module("repro.optim.schedule")
tsched = importlib.import_module("repro_torch.optim.schedule")
jadam = importlib.import_module("repro.optim.adamw")
tadam = importlib.import_module("repro_torch.optim.adamw")

METHODS = {"vanilla": ("vanilla", {}), "clipped": ("clipped_softmax", {"alpha": 4.0}),
           "gated": ("gated_attention", {})}
RTOL = 1e-5
PTQ_RTOL = 2e-4       # each package on its own calibrated ranges (see above)
RANGE_RTOL = 1e-6
SEQ, BATCH = 32, 2


def _data(pkg):
    return pkg.SyntheticLM(pkg.SyntheticLMConfig(vocab_size=128, seq_len=SEQ,
                                                 batch_size=BATCH, seed=0))


@pytest.fixture(scope="module")
def models():
    """Per method: (jax cfg, jax params, port cfg, port params)."""
    out = {}
    for m, (name, kw) in METHODS.items():
        jc, tc = japply(jsmoke(), name, **kw), tapply(tsmoke(), name, **kw)
        jp = jtr.model_init(jax.random.PRNGKey(0), jc)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
        out[m] = (jc, jp, tc, tp)
    return out


@pytest.mark.parametrize("kind", ["clm", "mlm", "frames"])
def test_synthetic_batches_bitwise(kind):
    j, t = _data(jsyn), _data(tsyn)
    for i in (0, 7, 10_000_000):
        jb, tb = j.batch(i, kind), t.batch(i, kind)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("kind", ["clm", "mlm", "frames"])
def test_losses_match_reference(kind):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    labels[0, 3] = labels[1, 5] = -100
    jn, jt = jloss.loss_for(kind)(jnp.asarray(logits), jnp.asarray(labels))
    tn, tt = tloss.loss_for(kind)(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tn), float(jn), atol=1e-6, rtol=1e-6)
    assert float(tt) == float(jt)


def test_outlier_functions_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 24)).astype(np.float32)
    x[0, 3, 5] = 40.0
    x[1, 9, 5] = -35.0
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert float(tout.infinity_norm(tx)) == float(jout.infinity_norm(jx))
    # kurtosis: fourth-moment f32 means, summed in another order than XLA's
    np.testing.assert_allclose(float(tout.kurtosis(tx)), float(jout.kurtosis(jx)), rtol=1e-5)
    np.testing.assert_allclose(tout.kurtosis(tx, axis=-1).numpy(),
                               np.asarray(jout.kurtosis(jx, axis=-1)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tout.outlier_mask(tx).numpy(), np.asarray(jout.outlier_mask(jx)))
    np.testing.assert_array_equal(tout.outlier_counts_by_dim(tx).numpy(),
                                  np.asarray(jout.outlier_counts_by_dim(jx)))
    np.testing.assert_array_equal(tout.outlier_counts_by_token(tx).numpy(),
                                  np.asarray(jout.outlier_counts_by_token(jx)))
    js = jout.collect_activation_stats({"a": jx, "b": jx[:1]})
    ts = tout.collect_activation_stats({"a": tx, "b": tx[:1]})
    for name in js:
        assert ts[name]["outliers_6sigma"] == js[name]["outliers_6sigma"]
        for key in ("inf_norm", "kurtosis"):
            np.testing.assert_allclose(ts[name][key], js[name][key], rtol=1e-5)
    jst, tst = jout.OutlierStats(), tout.OutlierStats()
    assert tst.summary() == jst.summary()
    for chunk in (x[:1], x[1:]):
        jst.update([jnp.asarray(chunk), jnp.asarray(chunk * 2)])
        tst.update([torch.from_numpy(chunk), torch.from_numpy(chunk * 2)])
    for key, val in jst.summary().items():
        np.testing.assert_allclose(tst.summary()[key], val, rtol=1e-5)


def test_schedules_and_optimizer_config_match_reference():
    assert dataclasses.asdict(tadam.AdamWConfig()) == dataclasses.asdict(jadam.AdamWConfig())
    assert [f.name for f in dataclasses.fields(tstep.TrainTask)] == \
        [f.name for f in dataclasses.fields(jstep.TrainTask)]
    for make, args in (("linear_warmup_linear_decay", (10, 100)),
                       ("linear_warmup_cosine", (10, 100)), ("constant", ())):
        jf, tf = getattr(jsched, make)(*args), getattr(tsched, make)(*args)
        for step in (0, 3, 10, 57, 100, 130):
            np.testing.assert_allclose(float(tf(step)), float(jf(step)), rtol=1e-6)


@pytest.mark.parametrize("method", list(METHODS))
def test_evaluate_matches_reference(models, method):
    """FP perplexity and the outlier summary (max inf-norm averaged over
    batches, kurtosis averaged over layers and batches)."""
    jc, jp, tc, tp = models[method]
    jppl, jst = jloop.evaluate(jstep.TrainTask(cfg=jc), jp, _data(jsyn), 2, "clm")
    tppl, tst = tloop.evaluate(tstep.TrainTask(cfg=tc), tp, _data(tsyn), 2, "clm")
    np.testing.assert_allclose(tppl, jppl, rtol=RTOL)
    assert tst["max_inf_norm"] > 0 and tst["avg_kurtosis"] > 0
    for key in jst:
        np.testing.assert_allclose(tst[key], jst[key], rtol=RTOL)


def _ptq_fns(pkg_tr, pkg_loss, pkg_qc, cfg, to_batch):
    def apply_fn(p, batch, ctx):
        return pkg_tr.model_apply(p, cfg, batch, ctx=ctx)[0]

    def loss_fn(p, batch, ctx):
        ctx = ctx if ctx is not None else pkg_qc.QuantContext(None)
        logits, _ = pkg_tr.model_apply(p, cfg, batch, ctx=ctx)
        return pkg_loss.loss_for("clm")(logits, batch["labels"])

    def batches(data, start, n):
        return [to_batch(data.batch(start + i, "clm")) for i in range(n)]

    return apply_fn, loss_fn, batches


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("method", list(METHODS))
def test_calibrate_and_w8a8_perplexity_match_reference(models, method):
    jc, jp, tc, tp = models[method]
    japp, jlf, jb = _ptq_fns(jtr, jloss, jqc, jc, _jbatch)
    tapp, tlf, tb = _ptq_fns(ttr, tloss, tqc, tc, _tbatch)
    jd, td = _data(jsyn), _data(tsyn)
    jctx = jptq.calibrate(japp, jp, jb(jd, 5_000_000, 4), jqc.QConfig(), num_batches=4)
    tctx = tptq.calibrate(tapp, tp, tb(td, 5_000_000, 4), tqc.QConfig(), num_batches=4)
    assert sorted(tctx.ranges) == sorted(jctx.ranges)
    for name, (lo, hi) in jctx.ranges.items():
        np.testing.assert_allclose([float(v) for v in tctx.ranges[name]],
                                   [float(lo), float(hi)], rtol=RANGE_RTOL)
    jppl = jptq.evaluate_perplexity(jlf, jp, jb(jd, 10_000_000, 2), jctx)
    tppl = tptq.evaluate_perplexity(tlf, tp, tb(td, 10_000_000, 2), tctx)
    np.testing.assert_allclose(tppl, jppl, rtol=PTQ_RTOL)
    # the reference's ranges loaded into the port: the same fake-quant grid
    loaded = tqc.QuantContext(tqc.QConfig())
    loaded.load_ranges({n: tuple(torch.tensor(np.asarray(v)) for v in r)
                        for n, r in jctx.ranges.items()})
    np.testing.assert_allclose(tptq.evaluate_perplexity(tlf, tp, tb(td, 10_000_000, 2), loaded),
                               jppl, rtol=RTOL)
    # and the fp perplexity of the same batches (no context)
    np.testing.assert_allclose(tptq.evaluate_perplexity(tlf, tp, tb(td, 10_000_000, 2)),
                               jptq.evaluate_perplexity(jlf, jp, jb(jd, 10_000_000, 2)),
                               rtol=RTOL)


@pytest.mark.parametrize("method", list(METHODS))
def test_ptq_sweep_matches_reference(models, method):
    """W8A8 over two calibration seeds, each seed on its own calibration
    batches: mean and std of the perplexity."""
    jc, jp, tc, tp = models[method]
    japp, jlf, jb = _ptq_fns(jtr, jloss, jqc, jc, _jbatch)
    tapp, tlf, tb = _ptq_fns(ttr, tloss, tqc, tc, _tbatch)

    def sweep(ptq, qc, app, lf, b, d, params):
        calls = iter(range(100))
        return ptq.ptq_sweep(app, lf, params,
                             lambda: b(d, 5_000_000 + 100 * next(calls), 2),
                             lambda: b(d, 10_000_000, 2), {"W8A8": qc.QConfig()},
                             seeds=(0, 1))

    want = sweep(jptq, jqc, japp, jlf, jb, _data(jsyn), jp)["W8A8"]
    got = sweep(tptq, tqc, tapp, tlf, tb, _data(tsyn), tp)["W8A8"]
    np.testing.assert_allclose(got["ppl_mean"], want["ppl_mean"], rtol=PTQ_RTOL)
    # the spread of two numbers that each agree to PTQ_RTOL
    np.testing.assert_allclose(got["ppl_std"], want["ppl_std"],
                               atol=2 * PTQ_RTOL * want["ppl_mean"])


@pytest.mark.parametrize("method", ["vanilla", "clipped"])
def test_scanned_layout_act_stats_and_no_attn_outputs(models, method):
    """A scanned config reports the per-layer max |attention-layer output|
    and, like the reference (``if acts and collect_acts``), no
    ``attn_outputs``: its evaluate() outlier summary stays at zeros."""
    jc, jp, tc, tp = models[method]
    jcs, tcs = dataclasses.replace(jc, scan_layers=True), dataclasses.replace(tc, scan_layers=True)
    jps = jtr.model_init(jax.random.PRNGKey(1), jcs)
    tps = from_jax_params(jax.tree_util.tree_map(np.asarray, jps), tcs, device="cpu")
    batch = _data(jsyn).batch(3, "clm")
    _, jaux = jtr.model_apply(jps, jcs, _jbatch(batch), collect_acts=True)
    _, taux = ttr.model_apply(tps, tcs, _tbatch(batch), collect_acts=True)
    assert "attn_outputs" not in jaux and "attn_outputs" not in taux
    assert taux["act_stats"].shape == jaux["act_stats"].shape == (tcs.n_groups, 1)
    np.testing.assert_allclose(taux["act_stats"].numpy(), np.asarray(jaux["act_stats"]),
                               atol=1e-5)
    out = tstep.make_eval_step(tstep.TrainTask(cfg=tcs))(tps, _tbatch(batch))
    jout_ = jstep.make_eval_step(jstep.TrainTask(cfg=jcs))(jps, _jbatch(batch))
    np.testing.assert_allclose(float(out["max_act"]), float(jout_["max_act"]), atol=1e-5)
    np.testing.assert_allclose(float(out["nll"]), float(jout_["nll"]), rtol=RTOL)
    _, tst = tloop.evaluate(tstep.TrainTask(cfg=tcs), tps, _data(tsyn), 1, "clm")
    assert tst == {"max_inf_norm": 0.0, "avg_kurtosis": 0.0}
    # the unrolled model returns one attention-layer output per layer
    _, taux = ttr.model_apply(tp, tc, _tbatch(batch), collect_acts=True)
    assert len(taux["attn_outputs"]) == tc.n_layers and "act_stats" not in taux
