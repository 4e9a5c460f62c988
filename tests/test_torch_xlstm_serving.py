"""xlstm-smoke (three mLSTM blocks and an sLSTM block, chunk 8) through
the port's serving, evaluation and training paths against the JAX
package's, on the CPU, in float32, on converted reference weights:

  * cache-free ``model_apply``: logits and every block output at atol 1e-4;
  * ``ContinuousBatcher`` greedy tokens, fp, paged and dense, at token
    budget 4 (prompts in many chunks; uniform recurrent sub-steps): equal
    to the reference batcher's; the engine audits clean and leaks no block;
  * W8A8 (``qconfig=QConfig()``; the xLSTM blocks carry no attention, so
    the clipped softmax and the gate do not touch them), paged (with
    ``kv_int8`` on, as the reference defaults it, and no pool to quantize)
    and dense: the engine's own calibration within rtol 1e-5 of the
    reference's at every site, and greedy tokens equal to the reference
    batcher's, whose ``int8_matmul`` runs as its source reads
    (``_int8_matmul_as_written``). Jitted as it stands, the reference's
    tick quantizes x * (1 / s) where its source divides, x / s (XLA turns a
    division by a constant into that product), and request 2's third
    token differs (119 for 19); op by op the reference divides and agrees
    with the port (ROADMAP section 3);
  * ``generate`` (one-shot prefill, then decode): tokens equal to the
    reference's;
  * ``evaluate`` (FP perplexity, max inf-norm, kurtosis at rtol 1e-5),
    ``calibrate`` (ranges at rtol 1e-5) and ``evaluate_perplexity`` (W8A8
    fake-quant perplexity at rtol 1e-3);
  * one ``make_train_step``: loss (rtol 1e-6), gradients (relative L2
    1e-2 per tensor) and the parameters after AdamW, as
    ``tests/test_torch_train.py`` holds the paper models."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget
from repro_torch.configs.base import get_arch as tget
from repro_torch.convert import from_jax_params
from repro_torch.models.transformer import row_leaves
from test_torch_train import GRAD_REL, LOSS_RTOL, LR, _assert_grads_close, _assert_step_close

jtr = importlib.import_module("repro.models.transformer")
ttr = importlib.import_module("repro_torch.models.transformer")
jserve = importlib.import_module("repro.serving")
tserve = importlib.import_module("repro_torch.serving")
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
jopt = importlib.import_module("repro.optim")
topt = importlib.import_module("repro_torch.optim")

ATOL = 1e-4
RTOL = 1e-5
PTQ_RTOL = 1e-3
MAX_NEW = 4


@pytest.fixture(scope="module")
def models():
    jc, tc = jget("xlstm-1.3b").smoke(), tget("xlstm-1.3b").smoke()
    jp = jtr.model_init(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(1, 120, size=n).astype(np.int32) for n in (8, 20, 13)]


def _serve(pkg, params, cfg, uids=(0, 1, 2), max_new=MAX_NEW, **kw):
    # one block a row: an xLSTM stack has no pool, and a single table width
    # keeps the reference's paged tick to one program per chunk length
    b = pkg.ContinuousBatcher(params, cfg, batch_size=2, max_len=32, block_size=32, **kw)
    for u in uids:
        b.submit(pkg.Request(uid=u, prompt=_prompts()[u], max_new_tokens=max_new))
    b.run()
    assert not b.failed
    return {r.uid: r.output.tolist() for r in b.done}, b


def _port(tp, tc, paged, uids=(0, 1, 2), max_new=MAX_NEW, **kw):
    out, b = _serve(tserve, tp, tc, uids, max_new, paged=paged, device="cpu",
                    debug_audit=paged, **kw)
    assert [len(out[u]) for u in uids] == [max_new] * len(uids)
    if paged:
        b.audit()
        assert b.allocator.available == b.num_blocks and (b.tables == -1).all()
    return out, b


def test_model_apply_logits_match_reference(models):
    jc, jp, tc, tp = models
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 21)).astype(np.int32)
    jl, jaux = jtr.model_apply(jp, jc, {"tokens": jnp.asarray(toks)}, collect_acts=True)
    tl, taux = ttr.model_apply(tp, tc, {"tokens": torch.from_numpy(toks)}, collect_acts=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert len(taux["attn_outputs"]) == len(jaux["attn_outputs"]) == 4
    for a, b in zip(taux["attn_outputs"], jaux["attn_outputs"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_fp_batcher_tokens_equal_reference(models, paged):
    jc, jp, tc, tp = models
    ref, _ = _serve(jserve, jp, jc, paged=paged, token_budget=4)
    got, b = _port(tp, tc, paged, token_budget=4)
    assert got == ref
    # recurrent rows run uniform sub-steps: no forward mixes chunk lengths
    assert b._uniform
    # the cells ride in the rows the scheduler resets and swaps
    names = {path[-2:] for path, _, _ in row_leaves(b.cache)}
    assert {("cell", 0), ("cell", 3), ("b0", "conv")} <= names


def _int8_matmul_as_written(x, w_q, w_scale, *, x_scale=None, x_zero=None, **_):
    """The reference's ``int8_matmul`` (static ranges) as its source reads,
    under jit too: the activation codes ``round(x / s)`` with ``s`` behind
    an optimization barrier, and the Pallas product as one integer
    ``jnp.dot`` (int8 x int8 -> int32, exact in any order, so bitwise the
    kernel's), then the same epilogue. Jitted as it stands, XLA turns the
    division by the constant ``s`` into a product with 1 / s, which
    rounds about half of all quotients another way."""
    x32 = x.astype(jnp.float32)
    s_x = jax.lax.optimization_barrier(jnp.float32(x_scale))
    z_x = jnp.float32(0.0 if x_zero is None else x_zero)
    xq_c = jnp.clip(jnp.clip(jnp.round(x32 / s_x) + z_x, 0, 255) - z_x,
                    -127, 127).astype(jnp.int8)
    acc = jnp.dot(xq_c, w_q, preferred_element_type=jnp.int32)
    return acc.astype(jnp.float32) * (s_x * w_scale)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_w8a8_batcher_tokens_equal_reference(models, monkeypatch, paged):
    jc, jp, tc, tp = models
    # jitted as it stands, the reference's tick quantizes x * (1 / s):
    # request 2's third token is then 119, not 19 (op by op, the reference
    # and the port divide and agree)
    monkeypatch.setattr(jint8, "int8_matmul", _int8_matmul_as_written)
    ref, jb = _serve(jserve, jp, jc, paged=paged, token_budget=4, qconfig=jqc.QConfig())
    got, b = _port(tp, tc, paged, token_budget=4, qconfig=tqc.QConfig())
    # each engine's own calibration (threefry tokens in both): equal sites,
    # ranges equal up to the fp forward's f32 rounding
    jq, tq = jb._qctx._act_qp, b._qctx._act_qp
    assert sorted(tq) == sorted(jq)
    assert {"layer_mlstm0/mlstm/up.in", "layer_mlstm0/mlstm/down.in",
            "layer_slstm3/slstm/zifo.in", "layer_slstm3/slstm/ff_down.in"} <= set(tq)
    for name, (s, z) in jq.items():
        np.testing.assert_allclose(tq[name][0], s, rtol=RTOL, err_msg=name)
        assert abs(tq[name][1] - z) <= 1, name
    assert got == ref
    assert b.kv_int8 == paged and not list(ttr.paged_entries(b.cache))
    # the int8 weights sit on every xLSTM projection, not on the gate
    # preactivations or the recurrences
    blk = b.params["layers"][0]
    assert {"w_q8", "w_scale"} <= set(blk["b0"]["blk"]["up"]) and \
        "w_q8" not in blk["b0"]["blk"]["ifgate"]
    assert {"w_q8", "w_scale"} <= set(blk["b3"]["blk"]["zifo"])


def test_generate_equals_reference(models):
    """A one-shot prefill of 13 tokens (the chunkwise form, its last chunk
    padded), then decode steps (the recurrent form); chunks with the state
    carried are the batcher's (budget 4, above)."""
    jc, jp, tc, tp = models
    prompt = np.random.default_rng(3).integers(1, 120, (2, 13)).astype(np.int32)
    jgen = jserve.generate(jp, jc, jnp.asarray(prompt), jserve.GenerateConfig(max_new_tokens=4))
    tgen = tserve.generate(tp, tc, torch.from_numpy(prompt),
                           tserve.GenerateConfig(max_new_tokens=4))
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


def _data(pkg):
    return pkg.SyntheticLM(pkg.SyntheticLMConfig(vocab_size=128, seq_len=24, batch_size=2,
                                                 seed=0))


def test_evaluation_path_matches_reference(models):
    jc, jp, tc, tp = models
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
    # one held-out batch: each reference fake-quant site interprets its kernel
    assert sorted(tctx.ranges) == sorted(jctx.ranges)
    assert {"layer_mlstm0/mlstm/gated", "layer_slstm3/slstm/ff_act",
            "layer_mlstm0/ln.out"} <= set(tctx.ranges)
    for name, (lo, hi) in jctx.ranges.items():
        np.testing.assert_allclose([float(v) for v in tctx.ranges[name]],
                                   [float(lo), float(hi)], rtol=RTOL, atol=1e-6, err_msg=name)
    jq = jptq.evaluate_perplexity(jlf, jp, jb(10_000_000, 1), jctx)
    tq = tptq.evaluate_perplexity(tlf, tp, tb(10_000_000, 1), tctx)
    np.testing.assert_allclose(tq, jq, rtol=PTQ_RTOL)


def test_train_step_matches_reference(models):
    jc, _, tc, _ = models
    jt = jstep.TrainTask(cfg=jc, loss_kind="clm", optimizer=jopt.AdamWConfig(lr=LR))
    tt = tstep.TrainTask(cfg=tc, loss_kind="clm", optimizer=topt.AdamWConfig(lr=LR))
    js = jstep.init_train_state(jax.random.PRNGKey(0), jt)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, js.params), tc, device="cpu")
    ts = tstep.TrainState(params, topt.adamw_init(params), None,
                          torch.zeros((), dtype=torch.int32))
    b = jsyn.SyntheticLM(jsyn.SyntheticLMConfig(vocab_size=128, seq_len=20,
                                                batch_size=2)).batch(0, "clm")

    def ref(state, batch):
        (loss, _), grads = jax.value_and_grad(jstep._loss_and_metrics, has_aux=True)(
            state.params, jt, batch)
        return loss, grads, jstep.make_train_step(jt)(state, batch)

    jl, jg, (js2, jm) = jax.jit(ref)(js, jax.tree_util.tree_map(jnp.asarray, b))
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    tl, _, tg = tstep._grads(ts.params, tt, tb)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _assert_grads_close(tg, jg)
    ts2, tm = tstep.make_train_step(tt)(ts, tb)
    assert int(ts2.step) == 1
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=GRAD_REL)
    _assert_step_close(jt, js2.params, ts2.params, jg, tg)
