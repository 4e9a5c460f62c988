"""ViT-S/16 at its full width (B 2, T 197) against the reference: logits,
``evaluate`` (FP perplexity and outlier statistics, rtol 1e-5) and the
W8A8 fake-quant perplexity (rtol 1e-3) over embeds batches (helpers:
``tests/test_torch_archs.py``)."""
import numpy as np
import pytest

from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_archs import (
    ATOL,
    METHODS,
    PTQ_RTOL,
    RTOL,
    _batch,
    _jax_apply,
    _jb,
    _models,
    _tb,
    jloop,
    jloss,
    jptq,
    jqc,
    jstep,
    jtr,
    tloop,
    tloss,
    tptq,
    tqc,
    tstep,
    ttr,
)


# ---------------------------------------------------------------------------
# ViT-S/16 at its full width
# ---------------------------------------------------------------------------
VIT_B, VIT_T = 2, 197


class _Embeds:
    """Seeded embeds batches at ``frontend_dim`` with per-position class
    labels: the reference's ``frames`` batches are 24 wide, which ViT's
    384-wide frontend cannot take."""

    def __init__(self, cfg):
        self.cfg = cfg

    def batch(self, index, kind="frames"):
        return _batch(self.cfg, VIT_B, VIT_T, seed=index)


@pytest.mark.parametrize("method", list(METHODS))
def test_vit_s16_logits_evaluate_and_w8a8_match_reference(method):
    jc, jp, tc, tp = _models("vit-s16", method)
    assert (tc.d_model, tc.n_layers, tc.frontend_dim) == (384, 12, 384)
    batch = _batch(tc, VIT_B, VIT_T, labels=False)
    jl, _ = _jax_apply(jp, jc, _jb(batch))
    tl, _ = ttr.model_apply(tp, tc, _tb(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)

    data = _Embeds(tc)
    jppl, jst = jloop.evaluate(jstep.TrainTask(cfg=jc, loss_kind="frames"), jp, data, 2,
                               "frames")
    tppl, tst = tloop.evaluate(tstep.TrainTask(cfg=tc, loss_kind="frames"), tp, data, 2,
                               "frames")
    np.testing.assert_allclose(tppl, jppl, rtol=RTOL)
    assert tst["max_inf_norm"] > 0
    for key in jst:
        np.testing.assert_allclose(tst[key], jst[key], rtol=RTOL)

    def fns(tr, loss, qc, cfg, to_batch):
        def apply_fn(p, b, ctx):
            return tr.model_apply(p, cfg, b, ctx=ctx)[0]

        def loss_fn(p, b, ctx):
            ctx = ctx if ctx is not None else qc.QuantContext(None)
            return loss.loss_for("frames")(tr.model_apply(p, cfg, b, ctx=ctx)[0], b["labels"])

        return apply_fn, loss_fn, lambda start, n: [to_batch(data.batch(start + i))
                                                    for i in range(n)]

    japp, jlf, jbat = fns(jtr, jloss, jqc, jc, _jb)
    tapp, tlf, tbat = fns(ttr, tloss, tqc, tc, _tb)
    jctx = jptq.calibrate(japp, jp, jbat(100, 2), jqc.QConfig(), num_batches=2)
    tctx = tptq.calibrate(tapp, tp, tbat(100, 2), tqc.QConfig(), num_batches=2)
    assert sorted(tctx.ranges) == sorted(jctx.ranges)
    assert "frontend_proj.out" in tctx.ranges
    jq = jptq.evaluate_perplexity(jlf, jp, jbat(200, 2), jctx)
    tq = tptq.evaluate_perplexity(tlf, tp, tbat(200, 2), tctx)
    np.testing.assert_allclose(tq, jq, rtol=PTQ_RTOL)
