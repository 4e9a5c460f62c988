"""The port's SLO machinery and swapped preemption against the JAX
package's, on the CPU: the eleven tests of ``tests/test_slo_serving.py``
run on the port's batcher (``device="cpu"``, converted ``opt_tiny``
weights), and where they compare tokens, the same scenario through the
reference's batcher must give the same tokens. Swap-resume equals
recompute-resume bitwise (fp and int8 KV), the bytes-vs-recompute cost
rule, bounded swap-in denial (the batcher's ``_swap_in_gate``), mid-prefill
cancellation on the dense, paged and int8-KV backends, deadline expiry and
timeouts, and the prefill budget."""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_workload import opt_tiny_models, shared_reference_step

jserve = importlib.import_module("repro.serving")
tserve = importlib.import_module("repro_torch.serving")


@pytest.fixture(scope="module")
def models():
    mp = shared_reference_step()
    yield opt_tiny_models(64)
    mp.undo()


def _engine(pkg, params, cfg, **kw):
    if pkg is tserve:
        kw["device"] = "cpu"
    return pkg.ContinuousBatcher(params, cfg, **kw)


def _port(models):
    return models[2], models[3]


def _both(models, scenario, *args, **kw):
    """``scenario(pkg, params, cfg, ...)`` on the port and on the
    reference; the port's tokens must equal the reference batcher's."""
    jc, jp, tc, tp = models
    got = scenario(tserve, tp, tc, *args, **kw)
    ref = scenario(jserve, jp, jc, *args, **kw)
    assert {u: np.asarray(v).tolist() for u, v in got.items()} == \
        {u: np.asarray(v).tolist() for u, v in ref.items()}
    return got


def _refs(params, cfg, prompts, max_new):
    return [tserve.generate(params, cfg, torch.as_tensor(p)[None, :],
                            tserve.GenerateConfig(max_new_tokens=m))[0, len(p):].numpy()
            for p, m in zip(prompts, max_new)]


def _prompts(n, size=8, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, 60, size=size).astype(np.int32) for _ in range(n)]


def _drain(b, ticks=400):
    while (b.queue or any(s.req is not None for s in b.slots)) and ticks:
        b.step()
        ticks -= 1
    assert ticks, "engine failed to drain"
    return {r.uid: r.output for r in b.done}


def _preempted_run(pkg, params, cfg, prompts, max_new, *, swap, kv_int8=False,
                   warm_ticks=6):
    """Run with a forced preemption of slot 0 after ``warm_ticks``; swap
    on/off toggles the resume mechanism, everything else identical."""
    b = _engine(pkg, params, cfg, batch_size=2, max_len=64, paged=True, block_size=4,
                num_blocks=16, kv_int8=kv_int8,
                swap_break_even_tokens=0 if swap else None, debug_audit=True)
    for u, (p, m) in enumerate(zip(prompts, max_new)):
        b.submit(pkg.Request(uid=u, prompt=p, max_new_tokens=m))
    for _ in range(warm_ticks):
        b.step()
    assert b.slots[0].req is not None
    victim = b.slots[0].req
    b.preempt_slot(0)
    if swap:
        assert victim.swapped is not None, "cost rule should pick swap"
    else:
        assert victim.swapped is None
    out = _drain(b)
    assert b.allocator.available == b.num_blocks
    b.audit()
    return out


def _unpreempted(pkg, params, cfg, prompts, max_new, **kw):
    b = _engine(pkg, params, cfg, batch_size=2, max_len=64, paged=True, block_size=4,
                num_blocks=16, **kw)
    for u, (p, m) in enumerate(zip(prompts, max_new)):
        b.submit(pkg.Request(uid=u, prompt=p, max_new_tokens=m))
    return _drain(b)


class TestSwappedPreemption:
    def test_swap_resume_bitwise_equals_recompute_fp(self, models):
        tc, tp = _port(models)
        prompts, max_new = _prompts(2), [12, 12]
        refs = _refs(tp, tc, prompts, max_new)
        swap = _both(models, _preempted_run, prompts, max_new, swap=True)
        reco = _preempted_run(tserve, tp, tc, prompts, max_new, swap=False)
        for u in range(2):
            np.testing.assert_array_equal(swap[u], reco[u], err_msg=f"uid={u}")
            np.testing.assert_array_equal(swap[u], refs[u], err_msg=f"uid={u}")

    def test_swap_resume_bitwise_equals_recompute_int8(self, models):
        """int8-KV: quantize-on-write makes pool bits a pure function of
        (value, position), so a swapped-out block row restores bit-identically
        and the resumed request emits the tokens of both the recompute path
        and an unpreempted engine."""
        tc, tp = _port(models)
        prompts, max_new = _prompts(2, seed=5), [12, 12]
        swap = _both(models, _preempted_run, prompts, max_new, swap=True, kv_int8=True)
        reco = _preempted_run(tserve, tp, tc, prompts, max_new, swap=False, kv_int8=True)
        oracle = _unpreempted(tserve, tp, tc, prompts, max_new, kv_int8=True)
        for u in range(2):
            np.testing.assert_array_equal(swap[u], reco[u], err_msg=f"uid={u}")
            np.testing.assert_array_equal(swap[u], oracle[u], err_msg=f"uid={u}")

    def test_cost_rule_thresholds_on_cached_tokens(self, models):
        """Victims below ``swap_break_even_tokens`` recompute; above it they
        swap. Both resume exactly."""
        tc, tp = _port(models)
        prompts, max_new = _prompts(2), [12, 12]
        refs = _refs(tp, tc, prompts, max_new)

        def run(pkg, params, cfg, threshold, took):
            b = _engine(pkg, params, cfg, batch_size=2, max_len=64, paged=True,
                        block_size=4, num_blocks=16, swap_break_even_tokens=threshold,
                        debug_audit=True)
            for u, (p, m) in enumerate(zip(prompts, max_new)):
                b.submit(pkg.Request(uid=u, prompt=p, max_new_tokens=m))
            for _ in range(4):
                b.step()
            victim, pos = b.slots[0].req, b.slots[0].pos
            b.preempt_slot(0)
            took.append((victim.swapped is not None, pos))   # consumed at swap-in
            return _drain(b)

        took = []
        out_lo = _both(models, run, 1, took)           # pos >= 1 -> swap
        assert all(swapped and pos >= 1 for swapped, pos in took) and len(took) == 2
        took = []
        out_hi = _both(models, run, 10_000, took)      # pos < 10k -> recompute
        assert not any(swapped for swapped, _ in took) and len(took) == 2
        for u in range(2):
            np.testing.assert_array_equal(out_lo[u], refs[u])
            np.testing.assert_array_equal(out_hi[u], refs[u])

    def test_swap_in_denial_degrades_to_recompute(self, models):
        """A victim whose swap-in keeps being denied burns its bounded
        retry budget, drops the host copy, and resumes via recompute —
        still token-exact, no leak, no livelock."""
        tc, tp = _port(models)
        prompts, max_new = _prompts(2), [12, 12]
        refs = _refs(tp, tc, prompts, max_new)

        def run(pkg, params, cfg):
            b = _engine(pkg, params, cfg, batch_size=2, max_len=64, paged=True,
                        block_size=4, num_blocks=16, swap_break_even_tokens=0,
                        swap_retry_limit=2, debug_audit=True)
            for u, (p, m) in enumerate(zip(prompts, max_new)):
                b.submit(pkg.Request(uid=u, prompt=p, max_new_tokens=m))
            for _ in range(6):
                b.step()
            victim = b.slots[0].req
            b.preempt_slot(0)
            assert victim.swapped is not None
            b._swap_in_gate = lambda req: False     # deny every swap-in
            for _ in range(8):
                b.step()
            assert victim.swapped is None, "retry budget must be bounded"
            assert b._swap_bytes == 0
            b._swap_in_gate = None
            return _drain(b)

        out = _both(models, run)
        for u in range(2):
            np.testing.assert_array_equal(out[u], refs[u], err_msg=f"uid={u}")


class TestMidPrefillCancel:
    """A request cancelled partway through chunked prefill frees its blocks
    and drops its remaining chunks the same tick, on every backend, and
    never perturbs its neighbours."""

    @staticmethod
    def _scenario(pkg, params, cfg, kv_int8, paged):
        long_p = _prompts(1, size=24, seed=11)[0]
        short_p = _prompts(1, size=6, seed=12)[0]
        kw = dict(batch_size=2, max_len=64, token_budget=8, debug_audit=paged)
        if paged:
            kw.update(paged=True, block_size=4, num_blocks=16, kv_int8=kv_int8)
        else:
            kw.update(paged=False)
        b = _engine(pkg, params, cfg, **kw)
        b.submit(pkg.Request(uid=0, prompt=long_p, max_new_tokens=8))
        b.submit(pkg.Request(uid=1, prompt=short_p, max_new_tokens=8))
        b.step()     # token_budget=8 < 24: uid0 is now mid-prefill
        mid = next(s for s in b.slots if s.req is not None and s.req.uid == 0)
        assert mid.prefill is not None and mid.prefill.done > 0
        assert b.cancel(0)
        assert all(s.req is None or s.req.uid != 0 for s in b.slots)
        if paged:
            held = sum(len(s.blocks) for s in b.slots)
            assert b.allocator.available == b.num_blocks - held
            b.audit()
        (cancelled,) = b.failed
        assert cancelled.uid == 0 and cancelled.status == "cancelled"
        out = _drain(b)
        assert 0 not in out
        if paged:
            assert b.allocator.available == b.num_blocks
        return out

    def _run(self, models, kv_int8=False, paged=True):
        tc, tp = _port(models)
        short_p = _prompts(1, size=6, seed=12)[0]
        (ref,) = _refs(tp, tc, [short_p], [8])
        out = _both(models, self._scenario, kv_int8, paged)
        np.testing.assert_array_equal(out[1], ref)

    def test_dense(self, models):
        self._run(models, paged=False)

    def test_paged(self, models):
        self._run(models, paged=True)

    def test_paged_int8(self, models):
        self._run(models, paged=True, kv_int8=True)


class TestDeadlines:
    def test_queued_request_expires_before_admission(self, models):
        tc, tp = _port(models)
        b = _engine(tserve, tp, tc, batch_size=2, max_len=64, paged=True, block_size=4,
                    num_blocks=16)
        b.submit(tserve.Request(uid=0, prompt=np.arange(4, 10, dtype=np.int32),
                                max_new_tokens=4, deadline=0.5))
        b.step(now=1.0)      # clock already past the deadline
        assert not b.queue and not b.done
        (req,) = b.failed
        assert req.status == "expired" and req.finish_time == 1.0

    def test_running_request_times_out_and_frees_blocks(self, models):
        tc, tp = _port(models)
        b = _engine(tserve, tp, tc, batch_size=2, max_len=64, paged=True, block_size=4,
                    num_blocks=16, debug_audit=True)
        b.submit(tserve.Request(uid=0, prompt=np.arange(4, 10, dtype=np.int32),
                                max_new_tokens=500, timeout=2.0))
        for t in (0.0, 1.0, 2.0, 3.0):
            b.step(now=t)
        (req,) = b.failed
        assert req.status == "timeout"
        assert len(req.output) > 0          # partial tokens delivered
        assert b.allocator.available == b.num_blocks
        b.audit()

    def test_deadline_met_requests_unaffected(self, models):
        tc, tp = _port(models)
        prompts, max_new = _prompts(2), [8, 8]
        refs = _refs(tp, tc, prompts, max_new)

        def run(pkg, params, cfg):
            b = _engine(pkg, params, cfg, batch_size=2, max_len=64, paged=True,
                        block_size=4, num_blocks=16)
            for u, (p, m) in enumerate(zip(prompts, max_new)):
                b.submit(pkg.Request(uid=u, prompt=p, max_new_tokens=m, deadline=1e9))
            return _drain(b)

        out = _both(models, run)
        for u in range(2):
            np.testing.assert_array_equal(out[u], refs[u])


class TestPrefillBudget:
    def test_prefill_budget_caps_prefill_tokens_per_tick(self, models):
        tc, tp = _port(models)
        long_p = _prompts(1, size=24, seed=21)[0]
        b = _engine(tserve, tp, tc, batch_size=2, max_len=64, token_budget=32,
                    prefill_budget=4, paged=True, block_size=4, num_blocks=16)
        b.submit(tserve.Request(uid=0, prompt=long_p, max_new_tokens=2))
        b.step()
        assert b.last_tick_tokens <= 4
        s = next(s for s in b.slots if s.req is not None)
        assert s.prefill is not None and s.prefill.done <= 4
