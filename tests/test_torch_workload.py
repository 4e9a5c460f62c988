"""The port's open-loop workload harness (``repro_torch.serving.workload``)
against the JAX package's, on the CPU.

``generate_trace`` draws the reference's numbers in the reference's order,
so a trace is bitwise the reference's for any ``WorkloadConfig`` (custom
tiers, cancellations, shared-prefix traffic). ``run_workload`` on the
virtual clock gives the same report, field by field, and the same tokens
through the port's batcher as through the reference's, on converted
``opt_tiny`` weights, over fp and int8 KV pools and with the prefix cache.
Then the seven tests of ``tests/test_workload.py``, against the port."""
import dataclasses
import importlib
import math

import jax
import numpy as np
import pytest

from repro.configs.paper_models import opt_tiny as jopt_tiny
from repro_torch.configs.paper_models import opt_tiny as topt_tiny
from repro_torch.convert import from_jax_params
from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)

jserve = importlib.import_module("repro.serving")
jsched = importlib.import_module("repro.serving.scheduler")
jwork = importlib.import_module("repro.serving.workload")
jqc = importlib.import_module("repro.quant.qconfig")
jtr = importlib.import_module("repro.models.transformer")
tserve = importlib.import_module("repro_torch.serving")
twork = importlib.import_module("repro_torch.serving.workload")

MAX_LEN = 160


def shared_reference_step():
    """Makes the reference's batchers share one jitted tick per (config,
    sampling config) until the returned MonkeyPatch is undone: the
    reference jits a fresh tick for every engine, and a test that builds
    many engines would compile the same programs again each time. W8A8
    ticks (a calibrated context) are left alone."""
    real = jsched.make_mixed_step
    memo = {}

    def make(cfg, gen, ctx=jqc.NO_QUANT):
        if ctx is not jqc.NO_QUANT:
            return real(cfg, gen, ctx)
        if (cfg, gen) not in memo:
            memo[(cfg, gen)] = real(cfg, gen)
        return memo[(cfg, gen)]

    mp = pytest.MonkeyPatch()
    mp.setattr(jsched, "make_mixed_step", make)
    return mp


def opt_tiny_models(max_len):
    """(jax cfg, jax params, port cfg, port params): ``opt_tiny`` at vocab
    64 and ``max_seq_len`` ``max_len``, the port's weights converted from
    the reference's ``PRNGKey(0)`` draw."""
    jc = dataclasses.replace(jopt_tiny(vocab=64, seq_len=32), max_seq_len=max_len)
    tc = dataclasses.replace(topt_tiny(vocab=64, seq_len=32), max_seq_len=max_len)
    jp = jtr.model_init(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def models():
    mp = shared_reference_step()
    yield opt_tiny_models(MAX_LEN)
    mp.undo()


def _batcher(pkg, params, cfg, **kw):
    base = dict(batch_size=4, max_len=MAX_LEN, token_budget=64, paged=True,
                num_blocks=48, block_size=8, debug_audit=True)
    if pkg is tserve:
        base["device"] = "cpu"
    base.update(kw)
    return pkg.ContinuousBatcher(params, cfg, **base)


def _wcfg(pkg, **kw):
    base = dict(seed=7, n_requests=14, rate=30.0, prompt_max=40, out_max=10)
    base.update(kw)
    return pkg.WorkloadConfig(**base)


def _tiers(pkg, *specs):
    return tuple(pkg.TierSpec(*s) for s in specs)


def report_fields(rep):
    """A report as plain data: every field, the derived rates and each
    tier's percentiles; NaN as the string "nan" so reports compare."""
    def plain(x):
        if isinstance(x, float) and math.isnan(x):
            return "nan"
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        return x
    d = dataclasses.asdict(rep)
    d["goodput_tok_s"], d["decode_tpot"] = rep.goodput_tok_s, rep.decode_tpot
    for name, tr in rep.tiers.items():
        d["tiers"][name].update(ttft_p50=tr.ttft_p50, ttft_p99=tr.ttft_p99,
                                tpot_p50=tr.tpot_p50, tpot_p99=tr.tpot_p99)
    return plain(d)


# (name, WorkloadConfig keywords with tiers as TierSpec tuples)
TRACE_CASES = [
    ("defaults", {}),
    ("cancel", dict(seed=7, n_requests=14, rate=30.0, prompt_max=40, out_max=10,
                    cancel_frac=0.25)),
    ("custom-tiers", dict(seed=3, n_requests=24, rate=400.0, prompt_max=32, out_max=8,
                          tiers=(("gold", 0.5, 2, 2.0, 0.3), ("scav", 0.5, 0, 2.0, 0.3)))),
    ("doomed", dict(seed=7, n_requests=6, tiers=(("doomed", 1.0, 0, 1e-9, 1e-9),))),
    ("prefix", dict(seed=11, n_requests=20, prefix_len=16, prefix_frac=0.5,
                    cancel_frac=0.1)),
    ("prefix-all-knobs-on-qwen-vocab", dict(
        seed=0, n_requests=48, rate=12.0, vocab=151936, prompt_log_mu=math.log(192.0),
        prompt_log_sigma=0.8, prompt_max=768, out_log_mu=math.log(24.0),
        out_log_sigma=0.7, out_max=96, cancel_frac=0.1, prefix_len=128,
        prefix_frac=0.5)),
    ("prefix-frac-zero", dict(seed=7, n_requests=14, prefix_len=16, prefix_frac=0.0)),
]


def _config(pkg, kw):
    kw = dict(kw)
    if "tiers" in kw:
        kw["tiers"] = _tiers(pkg, *kw["tiers"])
    return pkg.WorkloadConfig(**kw)


@pytest.mark.parametrize("name,kw", TRACE_CASES, ids=[c[0] for c in TRACE_CASES])
def test_generate_trace_equals_reference(name, kw):
    ref = jserve.generate_trace(_config(jserve, kw))
    got = tserve.generate_trace(_config(tserve, kw))
    assert len(got) == len(ref) == _config(tserve, kw).n_requests
    for g, r in zip(got, ref):
        assert (g.uid, g.arrival, g.tier, g.priority, g.max_new_tokens, g.deadline,
                g.cancel_at) == (r.uid, r.arrival, r.tier, r.priority, r.max_new_tokens,
                                 r.deadline, r.cancel_at)
        assert g.prompt.dtype == r.prompt.dtype == np.int32
        np.testing.assert_array_equal(g.prompt, r.prompt)
        req = g.request()
        assert isinstance(req, tserve.Request)
        assert (req.uid, req.max_new_tokens, req.priority, req.deadline) == \
            (r.uid, r.max_new_tokens, r.priority, r.deadline)
        np.testing.assert_array_equal(req.prompt, r.prompt)
        assert req.prompt is not g.prompt
    if name == "prefix-frac-zero":
        # the knob off draws nothing extra: the trace of the same seed
        # without it
        plain = tserve.generate_trace(_config(tserve, dict(seed=7, n_requests=14)))
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g.prompt, p.prompt)
            assert g.arrival == p.arrival


def test_tiers_cost_model_and_percentiles_equal_reference():
    assert [dataclasses.astuple(t) for t in tserve.DEFAULT_TIERS] == \
        [dataclasses.astuple(t) for t in jserve.DEFAULT_TIERS]
    assert dataclasses.astuple(tserve.TickCostModel()) == \
        dataclasses.astuple(jserve.TickCostModel())
    for n in (0, 1, 7, 256, 10_000):
        assert tserve.TickCostModel().cost(n) == jserve.TickCostModel().cost(n)
        assert tserve.TickCostModel(0.5, 0.1).cost(n) == jserve.TickCostModel(0.5, 0.1).cost(n)
    rng = np.random.default_rng(0)
    for xs in ([], [0.25], rng.random(7).tolist(), rng.random(100).tolist()):
        for q in (0.5, 0.99, 1.0):
            a, b = twork._pct(xs, q), jwork._pct(xs, q)
            assert a == b or (math.isnan(a) and math.isnan(b))
    with pytest.raises(ValueError):
        tserve.generate_trace(tserve.WorkloadConfig(tiers=()))


# (name, batcher keywords, WorkloadConfig keywords, TickCostModel arguments)
RUN_CASES = [
    ("fp-cancel", {}, dict(cancel_frac=0.25), (0.1, 0.01)),
    ("int8kv-slow", dict(kv_int8=True), dict(cancel_frac=0.25), (0.5, 0.1)),
    ("prefix", dict(prefix_cache=True, kv_int8=True), dict(n_requests=18, prefix_len=16,
                                                          prefix_frac=0.6), ()),
]


@pytest.mark.parametrize("name,bkw,wkw,cost", RUN_CASES, ids=[c[0] for c in RUN_CASES])
def test_run_workload_equals_reference(models, name, bkw, wkw, cost):
    """Virtual clock: the same report, field by field, the same outcome per
    request and the same tokens from both packages' batchers."""
    jc, jp, tc, tp = models
    reports, outs = [], []
    for pkg, params, cfg in ((jserve, jp, jc), (tserve, tp, tc)):
        b = _batcher(pkg, params, cfg, **bkw)
        rep = pkg.run_workload(b, pkg.generate_trace(_wcfg(pkg, **wkw)),
                               pkg.TickCostModel(*cost))
        b.audit()
        reports.append(report_fields(rep))
        outs.append(sorted((r.uid, r.status, None if r.output is None
                            else np.asarray(r.output).tolist())
                           for r in b.done + b.failed))
        if pkg is tserve:
            port = b
    assert reports[1] == reports[0]
    assert outs[1] == outs[0]
    statuses = {s for _, s, _ in outs[1]}
    assert "done" in statuses
    if "cancel" in name:
        assert "cancelled" in statuses
    if name == "prefix":
        assert port.prefix_cache.hits > 0 and port.shared_tokens > 0
    if name == "int8kv-slow":
        assert {"expired", "shed"} <= statuses


# ---------------------------------------------------------------------------
# tests/test_workload.py, against the port
# ---------------------------------------------------------------------------
def test_trace_deterministic_per_seed():
    a = tserve.generate_trace(_wcfg(tserve, cancel_frac=0.25))
    b = tserve.generate_trace(_wcfg(tserve, cancel_frac=0.25))
    assert len(a) == len(b) == 14
    for x, y in zip(a, b):
        assert x.uid == y.uid and x.arrival == y.arrival
        assert x.tier == y.tier and x.priority == y.priority
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert x.deadline == y.deadline and x.cancel_at == y.cancel_at
    c = tserve.generate_trace(_wcfg(tserve, seed=8, cancel_frac=0.25))
    assert any(x.arrival != y.arrival for x, y in zip(a, c))


def test_trace_shape_sanity():
    for e in tserve.generate_trace(_wcfg(tserve)):
        assert 1 <= len(e.prompt) <= 40
        assert 1 <= e.max_new_tokens <= 10
        assert e.deadline > e.arrival
        assert e.prompt.dtype == np.int32


def test_run_deterministic_and_reports_per_tier(models):
    _, _, tc, tp = models
    trace = tserve.generate_trace(_wcfg(tserve))
    r1 = tserve.run_workload(_batcher(tserve, tp, tc), trace, tserve.TickCostModel())
    r2 = tserve.run_workload(_batcher(tserve, tp, tc), trace, tserve.TickCostModel())
    assert r1.ticks == r2.ticks
    assert r1.goodput_tokens == r2.goodput_tokens
    assert r1.delivered_tokens == r2.delivered_tokens
    assert abs(r1.duration - r2.duration) < 1e-12
    assert r1.stall_p99 == r2.stall_p99
    offered = sum(t.offered for t in r1.tiers.values())
    accounted = sum(t.done + sum(t.failed.values()) for t in r1.tiers.values())
    assert offered == len(trace) == accounted
    for tr in r1.tiers.values():
        if tr.ttft:
            assert tr.ttft_p50 <= tr.ttft_p99
    assert r1.table()


def test_impossible_deadlines_expire_not_hang(models):
    _, _, tc, tp = models
    tight = _tiers(tserve, ("doomed", 1.0, 0, 1e-9, 1e-9))
    trace = tserve.generate_trace(_wcfg(tserve, tiers=tight, n_requests=6))
    rep = tserve.run_workload(_batcher(tserve, tp, tc), trace, tserve.TickCostModel())
    tr = rep.tiers["doomed"]
    assert tr.done + sum(tr.failed.values()) == 6
    assert rep.goodput_tokens == 0
    assert sum(tr.failed.values()) > 0


def test_cancellations_are_honored(models):
    _, _, tc, tp = models
    slow = tserve.TickCostModel(base=0.5, per_token=0.1)
    trace = tserve.generate_trace(_wcfg(tserve, cancel_frac=0.9, n_requests=8))
    rep = tserve.run_workload(_batcher(tserve, tp, tc), trace, slow)
    cancelled = sum(t.failed.get("cancelled", 0) for t in rep.tiers.values())
    assert cancelled > 0
    done = sum(t.done for t in rep.tiers.values())
    assert done + sum(sum(t.failed.values()) for t in rep.tiers.values()) == len(trace)


def test_overload_protects_high_priority(models):
    _, _, tc, tp = models
    tiers = _tiers(tserve, ("gold", 0.5, 2, 2.0, 0.3), ("scav", 0.5, 0, 2.0, 0.3))
    trace = tserve.generate_trace(_wcfg(tserve, tiers=tiers, n_requests=24, rate=400.0,
                                        prompt_max=32, out_max=8))
    rep = tserve.run_workload(
        _batcher(tserve, tp, tc, batch_size=2, token_budget=32, num_blocks=24),
        trace, tserve.TickCostModel(base=0.15, per_token=0.02))
    gold, scav = rep.tiers["gold"], rep.tiers["scav"]
    assert gold.offered > 0 and scav.offered > 0
    frac = lambda t: t.in_slo / t.offered  # noqa: E731
    assert frac(gold) >= frac(scav)


def test_first_token_time_drives_ttft(models):
    _, _, tc, tp = models
    b = _batcher(tserve, tp, tc)
    b.submit(tserve.Request(uid=0, prompt=np.arange(4, 10, dtype=np.int32),
                            max_new_tokens=3))
    t = 0.0
    while b.queue or any(s.req is not None for s in b.slots):
        b.step(now=t)
        t += 0.25
    (req,) = b.done
    assert req.submit_time == 0.0
    assert req.first_token_time is not None
    assert req.first_token_time <= req.finish_time


def test_wall_clock_mode_charges_measured_time(models):
    """``wall_clock=True``: each tick costs its measured span, so the
    report's duration is the sum of positive tick times and the same
    trace's tick count equals the virtual run's (the trace arrives at
    once)."""
    _, _, tc, tp = models
    loose = _tiers(tserve, ("loose", 1.0, 0, 1e3, 1e3))
    trace = tserve.generate_trace(_wcfg(tserve, rate=1e6, n_requests=6, tiers=loose))
    virt = tserve.run_workload(_batcher(tserve, tp, tc), trace, tserve.TickCostModel())
    wall = tserve.run_workload(_batcher(tserve, tp, tc), trace, wall_clock=True)
    assert wall.ticks == virt.ticks
    assert wall.duration > 0 and wall.tick_p50 > 0
    assert wall.duration != virt.duration
    assert wall.tiers["loose"].done == virt.tiers["loose"].done == 6
