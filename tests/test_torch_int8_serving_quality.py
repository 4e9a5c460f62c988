"""The port's copy of ``tests/test_int8_serving_quality.py``: the paper's
Table 2 story, served by the port. Greedy outputs of the port's W8A8 +
int8-KV batcher against its fp engine, for vanilla / clipped-softmax /
gated-attention ``opt_tiny`` models, on the paged and the dense cache.

Why trained models and injected outliers: see the reference test's
docstring. Random-init models have flat logits, so fp-vs-int8 argmax
agreement is a coin flip; the models are TRAINED (in JAX, by the
reference's own fixture protocol: 400 AdamW steps on the synthetic
Markov chain) and carried into the port with ``convert.from_jax_params``.
Tiny models never grow the paper's outliers, so "vanilla at scale" is
simulated by a function-preserving amplification of two fc1 channels by
M = 300 (relu(M x) = M relu(x), fc2 rows scaled by 1/M): the fp function
is unchanged, the per-tensor activation range at the fc2 input explodes.

Thresholds are the reference's: clean agreement >= 0.9 for every method
and cache, outlier-injected vanilla <= 0.6, clipped and gated above the
floor beside it. Also here, as in the reference: bitwise invariance of
int8-KV serving to chunk size, slot assignment and preemption-resume,
and of the full W8A8 + int8-KV stack to chunk size.

On the CPU the paged read is the port's plain gather path and the W8A8
linears the int8 kernel's plain version (the reference's
``backend="kernel"`` case runs the Pallas kernel in interpret mode; the
port's kernel runs only on the card, where ``chip_smoke.py`` holds it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import apply_method as japply
from repro.configs.paper_models import opt_tiny as jopt_tiny
from repro.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro.models import model_init as jmodel_init
from repro.optim.adamw import AdamWConfig
from repro.train.step import TrainTask, init_train_state, make_train_step
from repro_torch.configs.base import apply_method as tapply
from repro_torch.configs.paper_models import opt_tiny as topt_tiny
from repro_torch.convert import from_jax_params
from repro_torch.quant import QConfig
from repro_torch.serving import ContinuousBatcher, Request
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

VOCAB, SEQ = 64, 32
TRAIN_STEPS = 400
METHODS = ("vanilla", "clipped_softmax", "gated_attention")
# the reference's thresholds (its measurements: clean agreement 1.0 for
# every method x backend; outlier-vanilla 0.0 at M=300 x 2 channels)
CLEAN_FLOOR = 0.9
OUTLIER_CEIL = 0.6
QC = QConfig()
_SMALL = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=256)


def _cfgs(method):
    """(reference cfg, port cfg) of the Table 2 test's model."""
    out = []
    for apply, tiny in ((japply, jopt_tiny), (tapply, topt_tiny)):
        cfg = dataclasses.replace(tiny(vocab=VOCAB, seq_len=SEQ), **_SMALL)
        out.append(apply(cfg, method, alpha=4.0) if method == "clipped_softmax"
                   else apply(cfg, method))
    return tuple(out)


def _train(method):
    """The reference fixture's training, in JAX."""
    cfg = _cfgs(method)[0]
    task = TrainTask(cfg=cfg, optimizer=AdamWConfig(lr=1e-3))
    data = SyntheticLM(SyntheticLMConfig(vocab_size=VOCAB, seq_len=SEQ,
                                         batch_size=32, seed=0, branching=8))
    state = init_train_state(jax.random.PRNGKey(0), task)
    step_fn = jax.jit(make_train_step(task), donate_argnums=(0,))
    for i in range(TRAIN_STEPS):
        batch = jax.tree_util.tree_map(jnp.asarray, data.batch(i))
        state, _ = step_fn(state, batch)
    return state.params


def _inject_outliers(params, channels=(3, 11), m=300.0):
    """Function-preserving channel amplification (the reference's)."""
    broken = jax.tree_util.tree_map(jnp.asarray, params)
    for layer in broken["layers"]:
        blk = layer["b0"]
        for c in channels:
            blk["mlp"]["up"]["w"] = blk["mlp"]["up"]["w"].at[:, c].mul(m)
            blk["mlp"]["up"]["b"] = blk["mlp"]["up"]["b"].at[c].mul(m)
            blk["mlp"]["down"]["w"] = blk["mlp"]["down"]["w"].at[c, :].mul(1.0 / m)
    return broken


def _port(params, method):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params), _cfgs(method)[1],
                           device="cpu")


@pytest.fixture(scope="module")
def trained():
    """name -> (port params, method): the three trained models and the
    outlier-injected vanilla one, trained in JAX and converted."""
    jax_params = {m: _train(m) for m in METHODS}
    models = {m: (_port(p, m), m) for m, p in jax_params.items()}
    models["vanilla_outliers"] = (_port(_inject_outliers(jax_params["vanilla"]), "vanilla"),
                                  "vanilla")
    return models


@pytest.fixture(scope="module")
def prompts():
    data = SyntheticLM(SyntheticLMConfig(vocab_size=VOCAB, seq_len=SEQ,
                                         batch_size=32, seed=0, branching=8))
    batch = data.batch(999)
    return [batch["tokens"][i][:12].astype(np.int32) for i in range(6)]


def _run_engine(params, method, prompts, qconfig=None, paged=True, **kw):
    b = ContinuousBatcher(params, _cfgs(method)[1], batch_size=4, max_len=64, block_size=8,
                          paged=paged, qconfig=qconfig, device="cpu", **kw)
    for i, p in enumerate(prompts):
        b.submit(Request(uid=i, prompt=p, max_new_tokens=16))
    return {r.uid: np.asarray(r.output) for r in b.run()}


def _agreement(fp, q8):
    tot = match = 0
    for uid in fp:
        for x, y in zip(fp[uid], q8[uid]):
            tot += 1
            match += int(x == y)
    return match / max(tot, 1)


@pytest.fixture(scope="module")
def fp_outputs(trained, prompts):
    """Greedy fp baselines, one dense engine per model (fp paged and
    dense engines are token-exact; tests/test_torch_generate.py)."""
    return {name: _run_engine(p, method, prompts, paged=False)
            for name, (p, method) in trained.items()}


class TestTable2Agreement:
    """Outlier-free configs survive full INT8 serving; outliers break it."""

    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
    def test_clean_models_agree_with_fp(self, trained, prompts, fp_outputs,
                                        method, paged):
        q8 = _run_engine(trained[method][0], method, prompts, qconfig=QC, paged=paged)
        ag = _agreement(fp_outputs[method], q8)
        assert ag >= CLEAN_FLOOR, (method, paged, ag)

    def test_outlier_vanilla_degrades_paged(self, trained, prompts, fp_outputs):
        """The headline contrast: the same fp function as clean vanilla,
        but W8A8 + int8-KV serving collapses once per-tensor ranges carry
        outliers, while clipped and gated stay at the floor."""
        q8 = _run_engine(trained["vanilla_outliers"][0], "vanilla", prompts,
                         qconfig=QC, paged=True)
        bad = _agreement(fp_outputs["vanilla_outliers"], q8)
        assert bad <= OUTLIER_CEIL, bad
        for method in ("clipped_softmax", "gated_attention"):
            good = _agreement(fp_outputs[method],
                              _run_engine(trained[method][0], method, prompts,
                                          qconfig=QC, paged=True))
            assert good >= CLEAN_FLOOR > bad, (method, good, bad)

    def test_injection_preserves_the_fp_function(self, trained, fp_outputs):
        """relu(M x) = M relu(x): the injected model's fp tokens are the
        clean model's (up to f32 rounding of the scaled weights)."""
        assert _agreement(fp_outputs["vanilla"], fp_outputs["vanilla_outliers"]) >= CLEAN_FLOOR


class TestInt8KVInvariance:
    """Bitwise invariance of int8-KV serving (quantize-on-write pools) to
    scheduling accidents, on random-init weights (equality is bitwise,
    not statistical): kv_int8 alone first, then the full int8 stack."""

    @pytest.fixture(scope="class")
    def setup(self):
        params = _port(jmodel_init(jax.random.PRNGKey(1), _cfgs("gated_attention")[0]),
                       "gated_attention")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(4, VOCAB, size=n).astype(np.int32)
                   for n in (11, 5, 17, 8)]
        return params, prompts

    def _run(self, params, prompts, qconfig=None, **kw):
        b = ContinuousBatcher(params, _cfgs("gated_attention")[1], max_len=32, block_size=4,
                              paged=True, kv_int8=True, qconfig=qconfig, device="cpu",
                              debug_audit=True, **kw)
        for i, p in enumerate(prompts):
            b.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        out = {r.uid: np.asarray(r.output) for r in b.run()}
        b.audit()
        assert b.allocator.available == b.num_blocks
        return out

    def test_chunk_size_invariance(self, setup):
        params, prompts = setup
        ref = self._run(params, prompts, batch_size=4)
        for kw in (dict(token_budget=5), dict(token_budget=7), dict(prefill_chunk=3)):
            out = self._run(params, prompts, batch_size=4, **kw)
            for uid in ref:
                np.testing.assert_array_equal(out[uid], ref[uid], err_msg=f"{kw} uid={uid}")

    def test_slot_assignment_invariance(self, setup):
        params, prompts = setup
        ref = self._run(params, prompts, batch_size=4)
        for bsz in (1, 2):
            out = self._run(params, prompts, batch_size=bsz)
            for uid in ref:
                np.testing.assert_array_equal(out[uid], ref[uid], err_msg=f"B={bsz} uid={uid}")

    def test_preemption_resume_invariance(self, setup):
        params, prompts = setup
        roomy = self._run(params, prompts, batch_size=4)
        tight = self._run(params, prompts, batch_size=4, num_blocks=10)
        for uid in roomy:
            np.testing.assert_array_equal(tight[uid], roomy[uid], err_msg=f"uid={uid}")

    def test_full_int8_chunk_invariance(self, setup):
        params, prompts = setup
        ref = self._run(params, prompts, batch_size=4, qconfig=QC)
        out = self._run(params, prompts, batch_size=4, qconfig=QC, token_budget=6)
        for uid in ref:
            np.testing.assert_array_equal(out[uid], ref[uid], err_msg=f"uid={uid}")
