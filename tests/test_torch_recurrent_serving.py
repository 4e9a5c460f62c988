"""The port's serving engine on Griffin/ring configs against the JAX
package's, on the CPU, in float32.

``repro_torch.serving.ContinuousBatcher(paged=True, device="cpu")`` and
the reference ``repro.serving.ContinuousBatcher(paged=True)`` get the same
converted weights and requests: greedy tokens must be equal on
recurrentgemma-smoke (griffin, griffin, local_attn; window 8; a 2-block
griffin tail) and on a ("griffin", "attn") pattern (paged pools beside
recurrent state), at token budgets 256 (one uniform chunk per prompt) and
4 (many chunks, prompts past the window), for vanilla, clipped (alpha 4)
and gated attention. Inside the port: swap and recompute preemption of a
row past the window resume to the unpreempted tokens, a slot's second
occupant equals a fresh engine (the row reset), ``audit()`` stays clean
with no block leak, and ``spec=`` / ``prefix_cache=True`` raise the
reference's ``ValueError``."""
import dataclasses
import importlib

import jax
import numpy as np
import pytest

from repro.configs.base import apply_method as japply
from repro.configs.recurrentgemma_9b import smoke as jsmoke
from repro_torch.configs.base import apply_method as tapply
from repro_torch.configs.recurrentgemma_9b import smoke as tsmoke
from repro_torch.convert import from_jax_params

jtr = importlib.import_module("repro.models.transformer")
jserve = importlib.import_module("repro.serving")
tserve = importlib.import_module("repro_torch.serving")
tspec = importlib.import_module("repro_torch.serving.speculate")

METHODS = {"vanilla": {}, "clipped": {"alpha": 4.0}, "gated": {}}
_METHOD_NAME = {"vanilla": "vanilla", "clipped": "clipped_softmax",
                "gated": "gated_attention"}
PATTERNS = {"recurrentgemma": {}, "griffin+attn": dict(pattern=("griffin", "attn"))}
ENGINE = dict(batch_size=2, max_len=32, paged=True, block_size=8)
_MODELS: dict = {}


def _models(pattern, method):
    """(jax cfg, jax params, port cfg, port params), built once per pair."""
    key = (pattern, method)
    if key not in _MODELS:
        kw = METHODS[method]
        jc = dataclasses.replace(japply(jsmoke(), _METHOD_NAME[method], **kw),
                                 **PATTERNS[pattern])
        tc = dataclasses.replace(tapply(tsmoke(), _METHOD_NAME[method], **kw),
                                 **PATTERNS[pattern])
        jp = jtr.model_init(jax.random.PRNGKey(0), jc)
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
        _MODELS[key] = (jc, jp, tc, tp)
    return _MODELS[key]


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(1, 120, size=n).astype(np.int32) for n in (8, 20, 13)]


def _run(batcher_cls, req_cls, params, cfg, prompts, max_new=4, **kw):
    b = batcher_cls(params, cfg, **{**ENGINE, **kw})
    for u, p in enumerate(prompts):
        b.submit(req_cls(uid=u, prompt=p, max_new_tokens=max_new))
    b.run()
    return {r.uid: r.output.tolist() for r in b.done}, b


def _port(tp, tc, prompts, **kw):
    out, b = _run(tserve.ContinuousBatcher, tserve.Request, tp, tc, prompts,
                  device="cpu", debug_audit=True, **kw)
    b.audit()
    assert b.allocator.available == b.num_blocks and (b.tables == -1).all()
    return out, b


@pytest.mark.parametrize("budget", [256, 4])
@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_greedy_tokens_equal_reference_batcher(pattern, method, budget):
    jc, jp, tc, tp = _models(pattern, method)
    prompts = _prompts()
    ref, _ = _run(jserve.ContinuousBatcher, jserve.Request, jp, jc, prompts,
                  token_budget=budget)
    out, b = _port(tp, tc, prompts, token_budget=budget)
    assert out == ref
    assert len(out) == 3 and all(len(v) == 4 for v in out.values())
    assert b._uniform and b.forward_calls > 0


@pytest.mark.parametrize("swap", [False, True], ids=["recompute", "swap"])
def test_preemption_past_the_window_resumes_identically(swap):
    """Preempt the 20-token row after its prefill (past the window 8) and
    two decode steps; swap-resume carries the ring and recurrent rows
    to the host and back, recompute-resume re-prefills prompt + tokens."""
    _, _, tc, tp = _models("recurrentgemma", "clipped")
    prompts = _prompts()[1:2]
    want, _ = _port(tp, tc, prompts, token_budget=4, max_new=6)
    b = tserve.ContinuousBatcher(tp, tc, token_budget=4, device="cpu",
                                 swap_break_even_tokens=1 if swap else None,
                                 debug_audit=True, **ENGINE)
    b.submit(tserve.Request(uid=0, prompt=prompts[0], max_new_tokens=6))
    while not (b.slots[0].req is not None and len(b.slots[0].generated) == 3):
        b.step()
    assert b.slots[0].pos > tc.window
    b.preempt_slot(0)
    assert (b.queue[0].swapped is not None) == swap
    if swap:
        assert b.queue[0].swapped.row and not b.queue[0].swapped.pool
    b.run()
    b.audit()
    assert {r.uid: r.output.tolist() for r in b.done} == want
    assert b.allocator.available == b.num_blocks


def test_second_occupant_equals_fresh_engine():
    """One slot, two requests in turn: the second sees no ring position or
    recurrent state of the first (admission resets the row)."""
    _, _, tc, tp = _models("griffin+attn", "gated")
    _, _, rc, rp = _models("recurrentgemma", "vanilla")
    for cfg, params in ((tc, tp), (rc, rp)):
        first, second = _prompts()[1], _prompts()[2]
        both, _ = _port(params, cfg, [first, second], token_budget=4, batch_size=1)
        alone, _ = _port(params, cfg, [second], token_budget=4, batch_size=1)
        assert both[1] == alone[0]


def test_spec_and_prefix_cache_raise_reference_value_error():
    for pattern in PATTERNS:
        jc, jp, tc, tp = _models(pattern, "vanilla")
        for kw in (dict(spec=tspec.SpecConfig(k=2)), dict(prefix_cache=True)):
            jkw = dict(kw)
            if "spec" in jkw:
                jkw["spec"] = importlib.import_module(
                    "repro.serving.speculate").SpecConfig(k=2)
            with pytest.raises(ValueError) as ref:
                jserve.ContinuousBatcher(jp, jc, **ENGINE, **jkw)
            with pytest.raises(ValueError) as got:
                tserve.ContinuousBatcher(tp, tc, device="cpu", **ENGINE, **kw)
            assert str(got.value) == str(ref.value)


def test_sampled_parallel_branches_equal_reference_batcher():
    """``Request(n=2)`` on a config that cannot share blocks: the branches
    are independent requests (seeds base, base + 1), sampled at
    temperature 0.8 under the position-keyed rule, as the reference's."""
    jc, jp, tc, tp = _models("recurrentgemma", "gated")
    prompt = _prompts()[1]
    outs = []
    for cls, req, gen, kw in ((jserve.ContinuousBatcher, jserve.Request,
                               jserve.GenerateConfig(temperature=0.8), {}),
                              (tserve.ContinuousBatcher, tserve.Request,
                               tserve.GenerateConfig(temperature=0.8),
                               dict(device="cpu", debug_audit=True))):
        b = cls(jp if cls is jserve.ContinuousBatcher else tp,
                jc if cls is jserve.ContinuousBatcher else tc,
                gen=gen, token_budget=4, **ENGINE, **kw)
        b.submit(req(uid=3, prompt=prompt, max_new_tokens=5, n=2))
        b.run()
        (done,) = b.done
        outs.append([o.tolist() for o in done.outputs])
    assert outs[0] == outs[1]
    assert outs[1][0] != outs[1][1]            # the branches do diverge
