"""The port's training path against the JAX package's, on the CPU, in f32.

  * ``adamw_update`` (decay mask with and without App. B.3's norm-scale
    decay, a schedule's tensor ``lr_scale``, gradient clipping),
    ``global_norm`` / ``clip_by_global_norm`` and ``compress_grads`` (int8
    + error feedback) on the same inputs as the reference;
  * one ``make_train_step`` on ``opt_tiny`` and ``bert_tiny`` (vocab 128,
    T 32) from ``convert.from_jax_params``, vanilla, clipped (alpha 4) and
    gated: the loss and every gradient against ``jax.value_and_grad`` of
    the reference's loss, then the parameters after the AdamW step; the
    micro-batched step (2 splits: its accumulated gradients against
    ``jax.grad`` summed over the splits) and the grad-compress step
    against the reference's;
  * the port's copies of ``tests/test_train_ckpt.py`` (optimizer,
    schedule, compression, training, checkpoint round trip, keep-k,
    structure mismatch, atomic commit, resume);
  * checkpoints across the packages: a JAX checkpoint of an initial
    ``TrainState`` restored by the port's ``run_training`` and by the
    reference's, both running on from it with their histories compared;
    then a port checkpoint restored by the reference.

On the CPU ``attention()`` routes as the reference does (dense for these
sizes), so autograd differentiates the same plain attention XLA does; the
flash backward kernel is held on the card by ``chip_smoke.py`` phase 6."""
import dataclasses
import importlib
import os
import tempfile

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
from repro_torch.nn.module import flatten_params

jopt = importlib.import_module("repro.optim")
topt = importlib.import_module("repro_torch.optim")
jstep = importlib.import_module("repro.train.step")
tstep = importlib.import_module("repro_torch.train.step")
jtrain = importlib.import_module("repro.train")
ttrain = importlib.import_module("repro_torch.train")
jckpt = importlib.import_module("repro.checkpoint")
tckpt = importlib.import_module("repro_torch.checkpoint")
jsyn = importlib.import_module("repro.data.synthetic")
tsyn = importlib.import_module("repro_torch.data.synthetic")

VOCAB, SEQ, BATCH = 128, 32, 4
LR = 3e-3
METHODS = {"vanilla": ("vanilla", {}), "clipped": ("clipped_softmax", {"alpha": 4.0}),
           "gated": ("gated_attention", {})}
FAMILIES = {"opt": ("opt_tiny", "clm"), "bert": ("bert_tiny", "mlm")}
# AdamW on equal inputs: the same f32 operations in the same order; pow
# (b ** step) and sqrt may differ by an ulp between XLA and torch
OPT_RTOL = 1e-6
# A train step's loss: the same f32 forward up to the order of sums
LOSS_RTOL = 1e-6
# A train step's gradients, per tensor: relative L2 of the difference.
# Both packages differentiate the same plain f32 attention and MLPs, so
# most tensors agree to ~1e-6; but a ReLU pre-activation within an ulp of
# zero can land on the other side under the other order of sums (opt_tiny
# gated: one of layer 1's 512 hidden units on one token), which moves that
# unit's weight gradients and, below it, layer 0's by ~1e-3. A wrong
# gradient moves a tensor by O(1).
GRAD_REL = 1e-2
# Parameters after the AdamW step: the first step moves each by lr * (g /
# (|g| + eps) + wd * p), g clipped by the global norm. Where both
# packages' |g| > STEP_LIVE_G = 1e3 eps with one sign, the update is lr *
# sign(g) up to lr * eps / |g| <= 1e-3 lr, so the two new parameters
# agree to STEP_ATOL: that term plus the f32 rounding of p. Elsewhere the f32 noise of g decides
# the update (at random init attention is almost uniform and the q and k
# weights' gradients sit near eps: opt_tiny gated, a third of layer 1's
# q/k weights differ by ~5e-5 after one step), and a gradient whose sign
# differs moves it by up to 2 lr: PARAM_ATOL. At least STEP_LIVE_SHARE of
# each step's elements must fall under the tight check, so a step that
# applied no update fails it.
STEP_LIVE_G = 1e3 * 1e-8
STEP_ATOL = 1e-3 * LR + 1e-6
STEP_LIVE_SHARE = 0.5
PARAM_ATOL = 2 * LR * 1.01
# run_training histories from one checkpoint, 2 and 4 steps on: those q/k
# weights drift apart a little more each step (two f32 implementations of
# one function, not a fault: the loss agrees to ~1e-6 for the first 6
# steps), which moves the eval perplexity by ~1e-4 at step 4 and the
# outlier statistics, a max and a fourth moment of the activations, by
# ~1.5e-3
HIST_RTOL = {"step": 0, "loss": 1e-3, "eval_ppl": 1e-3, "max_inf_norm": 1e-2,
             "kurtosis": 1e-2}
# int8 gradient compression: a gradient within f32 noise of a rounding
# edge between two codes (x / s at k + 1/2) takes the other code, so its
# residual differs by one step s; the share of such elements is tiny
CODE_FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU suite runs six workers on the machine's cores, and torch's
    intra-op thread pool in each worker oversubscribes them: the port's
    CPU training loops (~35 ms a step alone) ran 100x slower beside the
    other workers. One thread per worker for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_np(tree):
    return dict(flatten_params(jax.tree_util.tree_map(np.asarray, tree)))


def _task_pair(family, method, **kw):
    maker, kind = FAMILIES[family]
    name, mkw = METHODS[method]
    jc = japply(getattr(jpm, maker)(vocab=VOCAB, seq_len=SEQ), name, **mkw)
    tc = tapply(getattr(tpm, maker)(vocab=VOCAB, seq_len=SEQ), name, **mkw)
    jt = jstep.TrainTask(cfg=jc, loss_kind=kind, optimizer=jopt.AdamWConfig(lr=LR), **kw)
    tt = tstep.TrainTask(cfg=tc, loss_kind=kind, optimizer=topt.AdamWConfig(lr=LR), **kw)
    return jt, tt, kind


def _states(jt, tt):
    """The reference's initial state and the port's copy of it."""
    js = jstep.init_train_state(jax.random.PRNGKey(0), jt)
    conv = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t), tt.cfg,  # noqa: E731
                                     device="cpu")
    params = conv(js.params)
    ef = None if js.ef is None else topt.ErrorFeedbackState(conv(js.ef.residual))
    ts = tstep.TrainState(params, topt.adamw_init(params), ef,
                          torch.zeros((), dtype=torch.int32))
    return js, ts


def _batch(kind, bs=BATCH, index=0):
    return jsyn.SyntheticLM(jsyn.SyntheticLMConfig(vocab_size=VOCAB, seq_len=SEQ,
                                                   batch_size=bs)).batch(index, kind)


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jb(b):
    return jax.tree_util.tree_map(jnp.asarray, b)


def _assert_grads_close(tgrads, jgrads):
    """Every gradient tensor at GRAD_REL (relative L2 of the difference)."""
    want = _tree_np(jgrads)
    for path, g in flatten_params(tgrads):
        w = want[path]
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        # the key bias's gradient is zero in exact arithmetic (rounding noise
        # on both sides): held against the largest gradient instead
        if path.endswith("/k/b"):
            assert np.abs(g.numpy() - w).max() < 1e-6
        else:
            assert err <= GRAD_REL, (path, err)


def _assert_step_close(jt, jparams, tparams, jgrads, tgrads):
    """The parameters after one AdamW step, given the gradients each side
    fed it: STEP_ATOL where both sides' clipped |g| > STEP_LIVE_G with one
    sign, PARAM_ATOL elsewhere (see above)."""
    clip = jt.optimizer.grad_clip_norm
    if clip is not None:
        jgrads = jopt.clip_by_global_norm(jgrads, clip)[0]
        tgrads = topt.clip_by_global_norm(tgrads, clip)[0]
    want, wg, tgs = _tree_np(jparams), _tree_np(jgrads), dict(flatten_params(tgrads))
    live = total = 0
    for path, x in flatten_params(tparams):
        g, tg = wg[path], tgs[path].numpy()
        tight = (np.minimum(np.abs(g), np.abs(tg)) > STEP_LIVE_G) & (np.sign(g) == np.sign(tg))
        d = np.abs(x.numpy() - want[path])
        assert d[tight].max(initial=0.0) <= STEP_ATOL, (path, d[tight].max())
        assert d.max() <= PARAM_ATOL, (path, d.max())
        live += int(tight.sum())
        total += d.size
    assert live >= STEP_LIVE_SHARE * total, (live, total)


def _ref_step_grads(jt, jparams, b):
    """The reference's gradient into AdamW: jax.grad of its loss, summed
    over ``jt.microbatch`` splits of the batch (the reference's split) and
    divided by their number."""
    mb = jt.microbatch
    grad = jax.jit(jax.grad(lambda p, x: jstep._loss_and_metrics(p, jt, x), has_aux=True))
    gs = [grad(jparams, _jb({k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                             for k, v in b.items()}))[0] for i in range(mb)]
    return jax.tree_util.tree_map(lambda *g: sum(g) / mb, *gs)


def _rand_tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"l": {"w": f(8, 4), "b": f(4)}, "ln": {"scale": f(4), "bias": f(4)},
            "layers": [{"q": {"w": f(4, 4)}}, {"lambda": f(3)}]}


# ---------------------------------------------------------------------------
# optimizer, clipping, compression against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decay_norm_scales", (False, True))
@pytest.mark.parametrize("clip", (None, 1.0))
def test_adamw_update_matches_reference(decay_norm_scales, clip):
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip_norm=clip,
               decay_norm_scales=decay_norm_scales)
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    params = _rand_tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    sched_j, sched_t = jopt.linear_warmup_linear_decay(2, 10), topt.linear_warmup_linear_decay(2, 10)
    for step in range(4):
        g = _rand_tree(10 + step)
        jp, js, jm = jopt.adamw_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, jc,
                                       sched_j(js.step + 1))
        tp, ts, tm = topt.adamw_update(jax.tree_util.tree_map(torch.from_numpy, g), ts, tp, tc,
                                       sched_t(ts.step + 1))
        assert int(ts.step) == int(js.step) == step + 1
        for tree_j, tree_t in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
            want = _tree_np(tree_j)
            for path, x in flatten_params(tree_t):
                np.testing.assert_allclose(x.numpy(), want[path], rtol=OPT_RTOL, atol=1e-9,
                                           err_msg=path)
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=OPT_RTOL)


def test_global_norm_and_clip_match_reference():
    g = _rand_tree(3)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = jax.tree_util.tree_map(torch.from_numpy, g)
    assert float(topt.global_norm(tg)) == pytest.approx(float(jopt.global_norm(jg)), rel=1e-7)
    for max_norm in (0.5, 100.0):
        jc, jn = jopt.clip_by_global_norm(jg, max_norm)
        tcl, tn = topt.clip_by_global_norm(tg, max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-7)
        want = _tree_np(jc)
        for path, x in flatten_params(tcl):
            np.testing.assert_allclose(x.numpy(), want[path], rtol=1e-6)


def test_compress_grads_matches_reference_bitwise():
    """Same per-tensor scale (a true division by 127), same round-half-even
    codes, same residual, over several error-feedback steps."""
    jef = jopt.ef_init(jax.tree_util.tree_map(jnp.asarray, _rand_tree(0)))
    tef = topt.ef_init(jax.tree_util.tree_map(torch.from_numpy, _rand_tree(0)))
    for step in range(3):
        g = _rand_tree(20 + step)
        jd, jef = jopt.compress_grads(jax.tree_util.tree_map(jnp.asarray, g), jef)
        td, tef = topt.compress_grads(jax.tree_util.tree_map(torch.from_numpy, g), tef)
        for tree_j, tree_t in ((jd, td), (jef.residual, tef.residual)):
            want = _tree_np(tree_j)
            for path, x in flatten_params(tree_t):
                np.testing.assert_array_equal(x.numpy(), want[path], err_msg=path)


def test_module_helpers_match_reference():
    """``param_count``, ``param_bytes``, ``cast_tree`` and ``DTypePolicy``
    (what a trainer sizes its optimizer state and mixed precision by)."""
    jnn, tnn = importlib.import_module("repro.nn"), importlib.import_module("repro_torch.nn")
    jt, tt, _ = _task_pair("opt", "gated")
    js, ts = _states(jt, tt)
    for tree_j, tree_t in ((js.params, ts.params), (js, ts)):
        assert tnn.param_count(tree_t) == jnn.param_count(tree_j)
        assert tnn.param_bytes(tree_t) == jnn.param_bytes(tree_j)
    half = tnn.cast_tree(ts, torch.bfloat16)
    want = dict(flatten_params(jnn.cast_tree(js, jnp.bfloat16)))
    for path, x in flatten_params(half):
        assert str(x.dtype).replace("torch.", "") == jnp.dtype(want[path].dtype).name, path
    assert tnn.param_bytes(half.params) == jnn.param_bytes(jnn.cast_tree(js.params, jnp.bfloat16))
    for name in ("bf16", "bf16_params_f32"):
        pj, pt = getattr(jnn.DTypePolicy, name)(), getattr(tnn.DTypePolicy, name)()
        for f in ("param_dtype", "compute_dtype"):
            assert str(getattr(pt, f)).replace("torch.", "") == jnp.dtype(getattr(pj, f)).name
    assert importlib.import_module("repro_torch.nn.module").F32 == tnn.DTypePolicy()


# ---------------------------------------------------------------------------
# one train step against jax.value_and_grad + adamw_update
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_reference(family, method):
    jt, tt, kind = _task_pair(family, method)
    js, ts = _states(jt, tt)
    b = _batch(kind)

    def ref(state, batch):
        (loss, _), grads = jax.value_and_grad(jstep._loss_and_metrics, has_aux=True)(
            state.params, jt, batch)
        return loss, grads, jstep.make_train_step(jt)(state, batch)

    jloss, jg, (js2, jm) = jax.jit(ref)(js, _jb(b))
    tloss, _, tg = tstep._grads(ts.params, tt, _tb(b))
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    _assert_grads_close(tg, jg)
    ts2, tm = tstep.make_train_step(tt)(ts, _tb(b))
    assert int(ts2.step) == 1 and int(ts2.opt.step) == 1
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=GRAD_REL)
    _assert_step_close(jt, js2.params, ts2.params, jg, tg)


@pytest.mark.parametrize("kw", ({"microbatch": 2}, {"grad_compress": True}),
                         ids=("microbatch", "grad_compress"))
def test_train_step_variants_match_reference(kw):
    jt, tt, kind = _task_pair("opt", "vanilla", **kw)
    js, ts = _states(jt, tt)
    b = _batch(kind)
    # the gradient each side feeds AdamW: accumulated over the splits, then
    # compressed against the initial error feedback
    jg = _ref_step_grads(jt, js.params, b)
    _, tg = tstep._step_grads(ts.params, tt, _tb(b))
    _assert_grads_close(tg, jg)
    if kw.get("grad_compress"):
        jg, tg = jopt.compress_grads(jg, js.ef)[0], topt.compress_grads(tg, ts.ef)[0]
    js2, jm = jax.jit(jstep.make_train_step(jt))(js, _jb(b))
    ts2, tm = tstep.make_train_step(tt)(ts, _tb(b))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    _assert_step_close(jt, js2.params, ts2.params, jg, tg)
    if kw.get("grad_compress"):
        want = _tree_np(js2.ef.residual)
        flips = total = 0
        for path, r in flatten_params(ts2.ef.residual):
            step = 2 * max(np.abs(want[path]).max(), 1e-30)       # ~ the int8 step s
            d = np.abs(r.numpy() - want[path])
            flips += int((d > 1e-3 * step).sum())
            total += d.size
        assert flips / total <= CODE_FLIP_SHARE, (flips, total)


def test_microbatch_equivalence():
    """As the reference's: 2 micro-batches of 2 give the step of one
    batch of 4 (f32 sums in another order)."""
    _, t1, kind = _task_pair("opt", "vanilla")
    _, t2, _ = _task_pair("opt", "vanilla", microbatch=2)
    s = tstep.init_train_state(0, t1, device="cpu")
    b = _tb(_batch(kind))
    s1, m1 = tstep.make_train_step(t1)(s, b)
    s2, m2 = tstep.make_train_step(t2)(s, b)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for (p, a), (_, c) in zip(flatten_params(s1.params), flatten_params(s2.params)):
        torch.testing.assert_close(a, c, rtol=0, atol=2e-5, msg=p)


def test_train_step_leaves_its_input_state():
    _, tt, kind = _task_pair("bert", "gated")
    s = tstep.init_train_state(0, tt, device="cpu")
    before = {p: x.clone() for p, x in flatten_params(s)}
    s2, _ = tstep.make_train_step(tt)(s, _tb(_batch(kind)))
    for p, x in flatten_params(s):
        assert torch.equal(x, before[p]), p
        assert not x.requires_grad
    assert all(not x.requires_grad for _, x in flatten_params(s2))


def test_prefill_and_decode_steps():
    _, tt, _ = _task_pair("opt", "vanilla")
    cfg = tt.cfg
    params = tstep.init_train_state(0, tt, device="cpu").params
    toks = torch.as_tensor(_batch("clm")["tokens"][:2, :8])
    last = tstep.make_prefill_step(cfg)(params, {"tokens": toks})
    from repro_torch.models import init_cache, model_apply
    full, _ = model_apply(params, cfg, {"tokens": toks})
    torch.testing.assert_close(last, full[:, -1, :])
    cache = init_cache(cfg, 2, 16, device="cpu")
    _, aux = model_apply(params, cfg, {"tokens": toks}, cache=cache, pos=0)
    nxt, cache = tstep.make_decode_step(cfg)(params, aux["cache"], last.argmax(-1)[:, None].int(), 8)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32


# ---------------------------------------------------------------------------
# the port's copies of tests/test_train_ckpt.py
# ---------------------------------------------------------------------------
def _tiny_task(**kw):
    return tstep.TrainTask(cfg=tpm.opt_tiny(vocab=128, seq_len=32), loss_kind="clm",
                           optimizer=topt.AdamWConfig(lr=3e-3), **kw)


def _data(vocab=128, seq=32, bs=4):
    return tsyn.SyntheticLM(tsyn.SyntheticLMConfig(vocab_size=vocab, seq_len=seq,
                                                   batch_size=bs))


class TestOptimizer:
    def test_adamw_decreases_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        state = topt.adamw_init(params)
        cfg = topt.AdamWConfig(lr=0.5, weight_decay=0.0, grad_clip_norm=None)
        for _ in range(200):
            g = {"w": 2 * params["w"]}
            params, state, _ = topt.adamw_update(g, state, params, cfg)
        torch.testing.assert_close(params["w"], torch.zeros(2), rtol=0, atol=1e-2)

    def test_weight_decay_mask(self):
        params = {"l": {"w": torch.ones(3), "b": torch.ones(3)},
                  "ln": {"scale": torch.ones(3)}}
        state = topt.adamw_init(params)
        cfg = topt.AdamWConfig(lr=1e-2, weight_decay=1.0, grad_clip_norm=None)
        zeros = jax.tree_util.tree_map(torch.zeros_like, params)
        new, _, _ = topt.adamw_update(zeros, state, params, cfg)
        assert float(new["l"]["w"][0]) < 1.0       # decayed
        assert float(new["l"]["b"][0]) == 1.0      # masked
        assert float(new["ln"]["scale"][0]) == 1.0  # masked
        # paper App. B.3: LN-gamma decay switch
        cfg2 = dataclasses.replace(cfg, decay_norm_scales=True)
        new2, _, _ = topt.adamw_update(zeros, state, params, cfg2)
        assert float(new2["ln"]["scale"][0]) < 1.0

    def test_grad_clip(self):
        g = {"w": torch.full((4,), 100.0)}
        clipped, norm = topt.clip_by_global_norm(g, 1.0)
        assert float(norm) == pytest.approx(200.0)
        assert float(torch.linalg.norm(clipped["w"])) == pytest.approx(1.0, rel=1e-5)

    def test_schedule(self):
        f = topt.linear_warmup_linear_decay(10, 100)
        assert float(f(0)) == 0.0
        assert float(f(10)) == pytest.approx(1.0)
        assert float(f(100)) == pytest.approx(0.0, abs=1e-6)

    def test_compression_error_feedback(self):
        """Error feedback conserves mass exactly: emitted + residual equals
        the sum of inputs, and components above the quantization step are
        transmitted accurately."""
        g = {"w": torch.tensor([1e-6, 1.0, -0.5])}
        ef = topt.ef_init(g)
        acc = torch.zeros(3)
        for _ in range(50):
            deq, ef = topt.compress_grads(g, ef)
            acc = acc + deq["w"]
        np.testing.assert_allclose(acc + ef.residual["w"], 50 * g["w"], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(acc[1:] / 50, g["w"][1:], rtol=0.02)


class TestTraining:
    def test_loss_decreases(self):
        """The reference's copy trains 40 steps, over which its eval
        perplexity moves by 0.25 % (118.77 -> 118.47), less than two f32
        implementations drift apart from one init in that time (the port
        from the reference's init: 118.75 -> 119.40); over 100 steps both
        fall by ~4 % (the reference 117.30 -> 114.62), so the port's copy
        evaluates at 50 and 100."""
        out = ttrain.run_training(_tiny_task(), _data(), ttrain.LoopConfig(
            total_steps=100, eval_every=50, eval_batches=2, log_every=0), device="cpu")
        h = out["history"]
        assert h["eval_ppl"][-1] < h["eval_ppl"][0]
        assert len(out["losses"]) == len(out["step_s"]) == 100

    def test_grad_compress_step_runs(self):
        t = _tiny_task(grad_compress=True)
        s = tstep.init_train_state(0, t, device="cpu")
        s, m = tstep.make_train_step(t)(s, _tb(_data().batch(0)))
        assert np.isfinite(float(m["loss"]))

    def test_entry_points_default_to_cuda(self):
        calls = [lambda: tstep.init_train_state(0, _tiny_task()),
                 lambda: ttrain.run_training(_tiny_task(), _data(), ttrain.LoopConfig(
                     total_steps=1, eval_every=0, log_every=0))]
        for call in calls:
            if torch.cuda.is_available():
                assert call() is not None
            else:
                with pytest.raises(RuntimeError, match="cuda"):
                    call()


class TestCheckpoint:
    def test_roundtrip_and_keep_k(self):
        state = tstep.init_train_state(0, _tiny_task(), device="cpu")
        with tempfile.TemporaryDirectory() as d:
            for s in (5, 10, 15, 20):
                tckpt.save_checkpoint(d, s, state, keep=2)
            assert sorted(os.listdir(d)) == ["step_00000015", "step_00000020"]
            restored, step = tckpt.restore_checkpoint(d, state)
            assert step == 20
            assert type(restored) is tstep.TrainState
            for (p, a), (_, b) in zip(flatten_params(state), flatten_params(restored)):
                assert torch.equal(a, b) and a.dtype == b.dtype, p

    def test_structure_mismatch_rejected(self):
        state = tstep.init_train_state(0, _tiny_task(), device="cpu")
        other = tstep.init_train_state(
            0, tstep.TrainTask(cfg=tpm.opt_tiny(vocab=64, seq_len=32)), device="cpu")
        with tempfile.TemporaryDirectory() as d:
            tckpt.save_checkpoint(d, 1, state)
            with pytest.raises(ValueError):
                tckpt.restore_checkpoint(d, other)

    def test_no_partial_checkpoint_visible(self):
        """Atomic commit: only fully-renamed step dirs count."""
        state = tstep.init_train_state(0, _tiny_task(), device="cpu")
        with tempfile.TemporaryDirectory() as d:
            tckpt.save_checkpoint(d, 7, state)
            os.makedirs(os.path.join(d, "step_00000009.tmp"))
            assert tckpt.latest_step(d) == 7

    def test_resume_continues_training(self):
        """Kill-and-restart: the loop resumes from the saved step."""
        with tempfile.TemporaryDirectory() as d:
            loop = ttrain.LoopConfig(total_steps=10, eval_every=0, log_every=0,
                                     ckpt_every=5, ckpt_dir=d)
            ttrain.run_training(_tiny_task(), _data(), loop, device="cpu")
            assert tckpt.latest_step(d) == 10
            loop2 = ttrain.LoopConfig(total_steps=12, eval_every=0, log_every=0,
                                      ckpt_every=5, ckpt_dir=d)
            out = ttrain.run_training(_tiny_task(), _data(), loop2, device="cpu")
            assert int(out["state"].step) == 12

    def test_resumed_run_is_bitwise_the_uninterrupted_one(self):
        task = _tiny_task()
        with tempfile.TemporaryDirectory() as d:
            full = ttrain.run_training(task, _data(), ttrain.LoopConfig(
                total_steps=6, eval_every=0, log_every=0, ckpt_every=3,
                ckpt_dir=os.path.join(d, "a")), device="cpu")
            os.makedirs(os.path.join(d, "b"))
            os.rename(os.path.join(d, "a", "step_00000003"),
                      os.path.join(d, "b", "step_00000003"))
            resumed = ttrain.run_training(task, _data(), ttrain.LoopConfig(
                total_steps=6, eval_every=0, log_every=0, ckpt_dir=os.path.join(d, "b")),
                device="cpu")
        assert resumed["losses"] == full["losses"][3:]
        for (p, a), (_, b) in zip(flatten_params(full["state"]),
                                  flatten_params(resumed["state"])):
            assert torch.equal(a, b), p


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------
def test_checkpoints_cross_between_packages():
    """A JAX checkpoint of an initial TrainState drives both loops; a port
    checkpoint restores into the reference's state."""
    jt, tt, kind = _task_pair("opt", "vanilla")
    loop = dict(total_steps=4, eval_every=2, eval_batches=1, log_every=0)
    data_j = jsyn.SyntheticLM(jsyn.SyntheticLMConfig(vocab_size=VOCAB, seq_len=SEQ,
                                                     batch_size=BATCH))
    data_t = tsyn.SyntheticLM(tsyn.SyntheticLMConfig(vocab_size=VOCAB, seq_len=SEQ,
                                                     batch_size=BATCH))
    with tempfile.TemporaryDirectory() as d:
        js = jstep.init_train_state(jax.random.PRNGKey(0), jt)
        for name in ("jax", "port"):
            jckpt.save_checkpoint(os.path.join(d, name), 0, js)
        out_j = jtrain.run_training(jt, data_j, jtrain.LoopConfig(
            ckpt_dir=os.path.join(d, "jax"), ckpt_every=4, **loop), batch_kind=kind,
            log=lambda _m: None)
        out_t = ttrain.run_training(tt, data_t, ttrain.LoopConfig(
            ckpt_dir=os.path.join(d, "port"), ckpt_every=4, **loop), batch_kind=kind,
            log=lambda _m: None, device="cpu")
        for key, rtol in HIST_RTOL.items():
            np.testing.assert_allclose(out_t["history"][key], out_j["history"][key],
                                       rtol=rtol, err_msg=key)
        # the port's step-4 checkpoint into the reference's state
        restored, step = jckpt.restore_checkpoint(os.path.join(d, "port"), js)
        assert step == 4 and int(restored.step) == 4 and int(restored.opt.step) == 4
        want = dict(flatten_params(out_t["state"]))
        for path, x in _tree_np(restored).items():
            np.testing.assert_array_equal(x, want[path].numpy(), err_msg=path)
        # and the reference's step-4 checkpoint into the port's state
        back, step = tckpt.restore_checkpoint(os.path.join(d, "jax"), out_t["state"])
        assert step == 4 and type(back) is tstep.TrainState
        want = _tree_np(out_j["state"])
        for path, x in flatten_params(back):
            np.testing.assert_array_equal(x.numpy(), want[path], err_msg=path)
