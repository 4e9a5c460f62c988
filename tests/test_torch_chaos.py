"""The port's fault injection (``repro_torch.serving.chaos``) against the
JAX package's, on the CPU.

``FaultPlan.random`` draws the reference's plan for any seed and rates.
Under the chaos smoke's six plans (its engine: 24 int8-KV blocks of 8,
swap past 16 tokens, shedding, the prefix cache), the port's harness over
the port's batcher and the reference's over the reference's give the same
event log, statuses, tokens, denied allocations, trie hits, copy-on-write
copies and evictions, on converted ``opt_tiny`` weights; so does a storm
plan (``chip_smoke.py``'s phase 11b plan: the prefix-storm rates with
preemption storms and swap-in denials at three and five times theirs).
The storm plan is the one that needs the batcher's swap-in gate: the
smoke's few swap-ins all fall outside its plans' deny windows, the storm
plan's do not, and without the gate the port ignores those denials and
the logs part at a preemption (event 28). Then the six tests of
``tests/test_chaos.py`` against the port, and the module's own smoke on
the CPU."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_workload import opt_tiny_models, shared_reference_step

jserve = importlib.import_module("repro.serving")
tserve = importlib.import_module("repro_torch.serving")
tchaos = importlib.import_module("repro_torch.serving.chaos")
tsched = importlib.import_module("repro_torch.serving.scheduler")

JUNK0 = tserve.ChaosHarness.JUNK_UID0
STORM = dict(p_alloc=0.10, p_storm=0.30, p_flood=0.05, p_deny=0.50, p_prefix=0.35)
# (id, request seed, plan)
PLANS = [(f"smoke-{seed}", seed, plan) for seed, plan in enumerate(tchaos.smoke_plans())] + \
    [("storm-6", 6, tserve.FaultPlan.random(6, ticks=30, **STORM))]


@pytest.fixture(scope="module")
def models():
    mp = shared_reference_step()
    yield opt_tiny_models(64)
    mp.undo()


@pytest.mark.parametrize("seed", [0, 1, 5, 17])
@pytest.mark.parametrize("rates", [{}, dict(p_prefix=0.35), dict(
    p_alloc=0.10, p_storm=0.30, p_flood=0.05, p_deny=0.50, p_prefix=0.35)],
    ids=["defaults", "prefix", "storm"])
def test_fault_plan_random_equals_reference(seed, rates):
    for ticks in (20, 40):
        got = tserve.FaultPlan.random(seed, ticks=ticks, **rates)
        ref = jserve.FaultPlan.random(seed, ticks=ticks, **rates)
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)


def test_smoke_plans_are_the_reference_smokes():
    plans = tchaos.smoke_plans()
    ref = [jserve.FaultPlan.random(s, ticks=30) for s in range(5)] + [
        jserve.FaultPlan.random(5, ticks=30, p_alloc=0.10, p_storm=0.08, p_flood=0.05,
                                p_deny=0.10, p_prefix=0.35)]
    assert [dataclasses.astuple(p) for p in plans] == [dataclasses.astuple(p) for p in ref]
    assert [bool(p.prefix_storm) for p in plans] == [False] * 5 + [True]


def _smoke_run(pkg, params, cfg, plan, seed):
    kw = dict(tchaos.SMOKE_ENGINE)
    if pkg is tserve:
        kw["device"] = "cpu"
    b = pkg.ContinuousBatcher(params, cfg, **kw)
    for r in tchaos.smoke_requests(seed):
        b.submit(pkg.Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                             priority=r.priority))
    h = pkg.ChaosHarness(b, plan)
    gate, gated = b._swap_in_gate, []
    b._swap_in_gate = lambda req: gated.append(gate(req)) or gated[-1]
    h.run()
    b.audit()
    return dict(events=h.events, swap_ins_denied=gated.count(False),
                done=sorted((r.uid, r.status, np.asarray(r.output).tolist()) for r in b.done),
                failed=sorted((r.uid, r.status) for r in b.failed),
                denied=b.allocator.denied, hits=b.prefix_cache.hits, cow=b.cow_copies,
                evictions=b.prefix_cache.evictions)


@pytest.mark.parametrize("name,seed,plan", PLANS, ids=[p[0] for p in PLANS])
def test_smoke_plans_equal_reference(models, name, seed, plan):
    """The JAX harness over the JAX batcher and the port's over the port's:
    the same events, statuses, tokens and counters, swap-in denials too.
    The storm plan denies swap-ins: it holds the batcher's
    ``_swap_in_gate``."""
    jc, jp, tc, tp = models
    jplan = jserve.FaultPlan(**dataclasses.asdict(plan))
    ref = _smoke_run(jserve, jp, jc, jplan, seed)
    got = _smoke_run(tserve, tp, tc, plan, seed)
    for k in ref:
        assert got[k] == ref[k], k
    assert got["done"]
    if plan.prefix_storm:
        assert got["hits"] > 0 and got["cow"] > 0 and got["denied"] > 0
    if name.startswith("storm"):
        assert got["swap_ins_denied"] > 0


def test_swap_in_gate_denies_and_degrades(models):
    """The gate's contract on the port's batcher, as the reference reads
    it: a denied swap-in costs an attempt, and past ``swap_retry_limit``
    the request drops its host copy and resumes by recompute."""
    _, _, tc, tp = models
    b = tserve.ContinuousBatcher(tp, tc, batch_size=2, max_len=64, paged=True, block_size=4,
                                 num_blocks=16, swap_break_even_tokens=0, swap_retry_limit=2,
                                 debug_audit=True, device="cpu")
    assert b._swap_in_gate is None
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 60, size=8).astype(np.int32) for _ in range(2)]
    for u, p in enumerate(prompts):
        b.submit(tserve.Request(uid=u, prompt=p, max_new_tokens=12))
    for _ in range(6):
        b.step()
    victim = b.slots[0].req
    b.preempt_slot(0)
    asked = []
    b._swap_in_gate = lambda req: asked.append(req.uid) or False
    b.step()
    assert asked == [victim.uid] and victim.swapped is not None
    assert victim.swapped.attempts == 1
    for _ in range(2):
        b.step()
    # the third denial spent the budget: host copy dropped, recompute
    assert asked == [victim.uid] * 3
    assert victim.swapped is None and b._swap_bytes == 0
    b._swap_in_gate = None
    while b.queue or any(s.req is not None for s in b.slots):
        b.step()
    assert b.allocator.available == b.num_blocks
    for r in b.done:
        np.testing.assert_array_equal(r.output, _ref(tp, tc, prompts[r.uid], 12))
    assert {r.uid for r in b.done} == {0, 1}


def test_faulty_allocator_delegates():
    inner = tsched.BlockAllocator(8)
    fa = tserve.FaultyAllocator(inner)
    assert (fa.num_blocks, fa.available) == (8, 8)
    blocks = fa.alloc(3)
    fa.acquire(blocks[:1])
    assert fa.refcount(blocks[0]) == 2 and fa.available == 5
    fa.failing = True
    assert fa.alloc(1) is None and fa.alloc(0) == [] and fa.denied == 1
    fa.acquire(blocks[1:2])                    # a bump never fails
    fa.release(blocks[:2])
    fa.free(blocks)
    assert fa.available == 8 and sorted(fa.free_list()) == sorted(inner.free_list())


def test_smoke_on_cpu(capsys):
    assert tchaos._smoke(device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("audit=clean") == 6 and "zero refcount-audit violations" in out


# ---------------------------------------------------------------------------
# tests/test_chaos.py, against the port
# ---------------------------------------------------------------------------
def _ref(params, cfg, prompt, m):
    out = tserve.generate(params, cfg, torch.as_tensor(prompt)[None, :],
                          tserve.GenerateConfig(max_new_tokens=m))
    return out[0, len(prompt):].numpy()


def _requests(n, seed, max_prompt=16, max_new=6):
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        plen = int(rng.integers(2, max_prompt + 1))
        reqs.append(tserve.Request(
            uid=uid, prompt=rng.integers(4, 60, size=plen).astype(np.int32),
            max_new_tokens=int(rng.integers(2, max_new + 1)),
            priority=int(rng.integers(0, 3))))
    return reqs


def _chaos_batcher(params, cfg, **kw):
    base = dict(batch_size=3, max_len=64, token_budget=32, paged=True,
                block_size=4, num_blocks=24, swap_break_even_tokens=8,
                on_pool_exhausted="shed", debug_audit=True, device="cpu")
    base.update(kw)
    return tserve.ContinuousBatcher(params, cfg, **base)


def _fresh(r):
    return dataclasses.replace(r, prompt=r.prompt.copy(), output=None)


def test_fault_plans_are_seeded_and_distinct():
    plans = [tserve.FaultPlan.random(s, ticks=40) for s in range(5)]
    again = [tserve.FaultPlan.random(s, ticks=40) for s in range(5)]
    assert plans == again
    assert len({p for p in plans}) == 5
    assert any(p.alloc_fail for p in plans)
    assert any(p.preempt_storm for p in plans)
    assert any(p.flood for p in plans)
    assert any(p.swap_deny for p in plans)


def test_five_plans_no_crash_no_audit_violation_survivors_exact(models):
    _, _, tc, tp = models
    reqs = _requests(8, seed=42)
    for seed in range(5):
        plan = tserve.FaultPlan.random(seed, ticks=20)
        b = _chaos_batcher(tp, tc, kv_int8=True)
        for r in reqs:
            b.submit(_fresh(r))
        h = tserve.ChaosHarness(b, plan)
        h.run()
        b.audit()
        for req in b.done:
            if req.uid >= JUNK0:
                continue
            assert len(req.output) == req.max_new_tokens
            assert req.status == "done"
        for req in b.failed:
            assert req.status in ("shed", "cancelled", "expired", "timeout")
        assert b.allocator.available == b.num_blocks


def _storm_outputs(params, cfg, reqs, kv_int8, storm_seed):
    b = _chaos_batcher(params, cfg, kv_int8=kv_int8, on_pool_exhausted="raise")
    for r in reqs:
        b.submit(_fresh(r))
    rng = np.random.default_rng(storm_seed)
    ticks = 0
    while (b.queue or any(s.req is not None for s in b.slots)) and ticks < 500:
        if rng.random() < 0.3:
            live = [i for i, s in enumerate(b.slots) if s.req is not None]
            if live:
                b.preempt_slot(int(rng.choice(live)))
        if rng.random() < 0.1:
            cancellable = [r.uid for r in b.queue] + \
                [s.req.uid for s in b.slots if s.req is not None]
            if cancellable:
                b.cancel(int(rng.choice(cancellable)))
        b.step()
        b.audit()
        ticks += 1
    assert ticks < 500, "storm failed to drain"
    assert b.allocator.available == b.num_blocks
    return b


def _unpreempted(params, cfg, reqs, **kw):
    ob = _chaos_batcher(params, cfg, on_pool_exhausted="raise", **kw)
    for r in reqs:
        ob.submit(_fresh(r))
    while ob.queue or any(s.req is not None for s in ob.slots):
        ob.step()
    return {r.uid: r.output for r in ob.done}


def test_preemption_storm_survivors_exact_fp(models):
    _, _, tc, tp = models
    reqs = _requests(6, seed=1)
    oracle = _unpreempted(tp, tc, reqs)
    for storm_seed in (0, 1):
        b = _storm_outputs(tp, tc, reqs, False, storm_seed)
        assert b.done, "storm cancelled everything (seed too hostile)"
        for req in b.done:
            np.testing.assert_array_equal(req.output, oracle[req.uid],
                                          err_msg=f"storm={storm_seed} uid={req.uid}")
        for req in b.failed:
            assert req.status == "cancelled"


def test_preemption_storm_survivors_exact_int8(models):
    _, _, tc, tp = models
    reqs = _requests(6, seed=2)
    oracle = _unpreempted(tp, tc, reqs, kv_int8=True)
    b = _storm_outputs(tp, tc, reqs, True, storm_seed=0)
    assert b.done
    for req in b.done:
        np.testing.assert_array_equal(req.output, oracle[req.uid], err_msg=f"uid={req.uid}")


def test_transient_alloc_fault_recovers_without_shedding(models):
    _, _, tc, tp = models
    reqs = _requests(4, seed=9, max_prompt=10)
    oracle = {r.uid: _ref(tp, tc, r.prompt, r.max_new_tokens) for r in reqs}
    b = _chaos_batcher(tp, tc, on_pool_exhausted="raise")
    b.allocator = tserve.FaultyAllocator(b.allocator)
    for r in reqs:
        b.submit(_fresh(r))
    for t in range(200):
        b.allocator.failing = 2 <= t <= 4
        b.step()
        b.audit()
        if not b.queue and all(s.req is None for s in b.slots):
            break
    assert b.allocator.denied > 0, "fault window never bit"
    assert not b.failed
    assert len(b.done) == len(reqs)
    for req in b.done:
        np.testing.assert_array_equal(req.output, oracle[req.uid])


def test_persistent_fault_sheds_in_priority_order(models):
    _, _, tc, tp = models
    rng = np.random.default_rng(0)
    prios = [2, 2, 1, 0, 1, 0]
    b = _chaos_batcher(tp, tc, batch_size=2, fault_shed_after=3, on_pool_exhausted="raise")
    b.allocator = tserve.FaultyAllocator(b.allocator)
    b.allocator.failing = True
    for uid, p in enumerate(prios):
        b.submit(tserve.Request(
            uid=uid, prompt=rng.integers(4, 60, size=6).astype(np.int32),
            max_new_tokens=4, priority=p))
    for _ in range(120):
        b.step()
        b.audit()
        if not b.queue and all(s.req is None for s in b.slots):
            break
    assert not b.done
    shed = [r for r in b.failed if r.status == "shed"]
    assert len(shed) == len(prios)
    shed_prios = [r.priority for r in shed]
    assert shed_prios == sorted(shed_prios), f"sheds out of priority order: {shed_prios}"
