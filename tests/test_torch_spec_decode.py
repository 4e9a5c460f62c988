"""Truncation inside an accepted speculative run, in the port, on the CPU.

The port's copies of the reference's ``TestLossless.test_eos_inside_accepted_run``
and ``test_max_new_tokens_exact`` (``tests/test_spec_decode.py``), on the
same tiny 2-layer model (weights converted from the reference's
``model_init(PRNGKey(0))``). The reference's fixed ``(2, 9)`` motif prompt
no longer drives that model into a period-2 greedy tail, so the port's
copies search at test time, among two-token motif prompts, for one whose
greedy tail IS a period-2 cycle (A, B, A, B, ...), then teacher-force a
prompt that ends mid-cycle. Speculation then accepts drafts from its
first tick, and the banked run must stop exactly at EOS or at
``max_new_tokens``. Each result is held against spec off, the port's own
``generate`` and the reference's speculative batcher."""

import jax
import numpy as np
import pytest
import torch

import repro.serving as jserve
import repro_torch.serving as tserve
from repro.models.transformer import ModelConfig as JaxConfig
from repro.models.transformer import model_init
from repro_torch.convert import from_jax_params
from repro_torch.models.transformer import ModelConfig

TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
            vocab_size=64, pos="rope", max_seq_len=1024, scan_layers=False,
            remat=False, mlp_kind="swiglu", norm="rmsnorm")
ENGINE = dict(batch_size=4, max_len=96, paged=True, block_size=8, num_blocks=56,
              debug_audit=True)


@pytest.fixture(scope="module")
def setup():
    """(jax cfg, jax params, port cfg, port params)."""
    jc, tc = JaxConfig(**TINY), ModelConfig(**TINY)
    jp = model_init(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


def _motif_prompt(n, motif):
    return np.asarray((list(motif) * (-(-n // len(motif))))[:n], np.int32)


def _run(serve, params, cfg, prompt, max_new, spec=None, **kw):
    extra = dict(device="cpu") if serve is tserve else {}
    b = serve.ContinuousBatcher(params, cfg, **ENGINE, spec=spec, **extra, **kw)
    b.submit(serve.Request(uid=0, prompt=prompt.copy(), max_new_tokens=max_new))
    b.run()
    b.audit()
    return b.done[0].output.tolist(), b


def _generate(tp, tc, prompt, max_new, eos_id=None):
    gen = tserve.GenerateConfig(max_new_tokens=max_new, eos_id=eos_id)
    return tserve.generate(tp, tc, torch.from_numpy(prompt)[None], gen)[0, len(prompt):].tolist()


def _period2_probe(setup, tail):
    """A 24-token two-token-motif prompt whose greedy continuation of 32
    tokens (the port's engine, spec off) ends in ``tail`` tokens
    alternating between two different ids. Candidates are screened in
    one batched ``generate`` call and confirmed on the engine."""
    _, _, tc, tp = setup
    pairs = [(a, b) for a in range(1, 64) for b in range(1, 64) if a != b][:400]
    prompts = np.stack([_motif_prompt(24, m) for m in pairs])
    screen = tserve.generate(tp, tc, torch.from_numpy(prompts),
                             tserve.GenerateConfig(max_new_tokens=32))[:, 24:].numpy()

    def period2(out):
        end = list(out[-tail:])
        return end[0] != end[1] and all(end[j] == end[j % 2] for j in range(tail))

    for i in np.flatnonzero([period2(o) for o in screen]):
        prompt = prompts[i]
        out0, _ = _run(tserve, tp, tc, prompt, 32)
        if period2(out0):
            return prompt, out0
    pytest.fail("no two-token motif prompt gives this model a period-2 greedy tail")


def test_eos_inside_accepted_run(setup):
    # Force EOS to land INSIDE an accepted draft, not as a plain decode
    # token: teacher-force a prompt that ends mid-cycle and set eos=B. The
    # drafter's first proposal is [B, A, B, A], the verifier accepts it,
    # and the kept run must truncate at the first banked B.
    jc, jp, tc, tp = setup
    probe, out0 = _period2_probe(setup, 5)
    cut = len(out0) - 5
    a, eos = out0[cut], out0[cut + 1]          # continuation = [a, eos, a, ...]
    assert a != eos and out0[cut:] == [a, eos, a, eos, a]
    prompt = np.concatenate([probe, np.asarray(out0[:cut], np.int32)])
    base, _ = _run(tserve, tp, tc, prompt, 16, eos_id=eos)
    out, b = _run(tserve, tp, tc, prompt, 16, spec=tserve.SpecConfig(k=4), eos_id=eos)
    assert out == base == [a, eos]             # truncated at EOS mid-accepted-run
    assert b.spec_drafted > 0 and b.spec_accepted > 0
    assert _generate(tp, tc, prompt, 16, eos_id=eos) == [a, eos] + [0] * 14
    ref, _ = _run(jserve, jp, jc, prompt, 16, spec=jserve.SpecConfig(k=4), eos_id=eos)
    assert ref == out


def test_max_new_tokens_exact(setup):
    # teacher-forced cyclic prompt (same trick as the EOS test): the run
    # accepts drafts from tick one, and max_new_tokens must clamp the
    # banked tokens exactly — the draft cap and the kept loop both respect
    # the remaining room
    jc, jp, tc, tp = setup
    probe, out0 = _period2_probe(setup, 7)
    cut = len(out0) - 7
    a, b_ = out0[cut], out0[cut + 1]
    assert a != b_ and out0[cut:] == [a, b_, a, b_, a, b_, a]
    prompt = np.concatenate([probe, np.asarray(out0[:cut], np.int32)])
    base, _ = _run(tserve, tp, tc, prompt, 3)
    out, b = _run(tserve, tp, tc, prompt, 3, spec=tserve.SpecConfig(k=5))
    assert out == base == out0[cut:cut + 3]    # exact clamp mid-accepted-run
    assert b.spec_drafted > 0 and b.spec_accepted > 0
    assert _generate(tp, tc, prompt, 3) == out
    ref, _ = _run(jserve, jp, jc, prompt, 3, spec=jserve.SpecConfig(k=5))
    assert ref == out


def test_dense_engine_truncates_like_paged(setup):
    """The same EOS truncation on the dense cache (``paged=False``)."""
    _, _, tc, tp = setup
    probe, out0 = _period2_probe(setup, 5)
    cut = len(out0) - 5
    a, eos = out0[cut], out0[cut + 1]
    prompt = np.concatenate([probe, np.asarray(out0[:cut], np.int32)])
    dense = dict(ENGINE, paged=False)
    b = tserve.ContinuousBatcher(tp, tc, **dense, spec=tserve.SpecConfig(k=4), eos_id=eos,
                                 device="cpu")
    b.submit(tserve.Request(uid=0, prompt=prompt, max_new_tokens=16))
    b.run()
    assert b.done[0].output.tolist() == [a, eos] and b.spec_accepted > 0
