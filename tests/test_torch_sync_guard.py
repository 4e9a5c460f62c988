"""Host-sync tripwire (repro_torch.analysis.sync_guard): the guard's
mechanics, then the serving tick's syncs pinned at today's counts while
tiny engines sweep live widths, chunk sizes and draft lengths (the
counterpart of ``tests/test_compile_guard.py``'s sweeps), and the guard
FAILS when a sync is added to the forward — the runtime complement of
lint rule R001.

Today a tick pays ``TICK_SYNCS_PER_FORWARD`` (2) syncs per forward: the
write targets' ``nonzero`` and the ``.cpu()`` of the sampled tokens; a
sampling engine pays PRNGKey's range check on top. Each engine runs on
the CPU; the guard counts there what it counts on the card
(``chip_smoke.py``'s sync phase holds the same budget on the H100).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import sync_guard
from repro_torch.analysis.sync_guard import (SAMPLED_TICK_SYNCS_PER_FORWARD,
                                             TICK_SYNCS_PER_FORWARD, SyncBudgetExceeded,
                                             SyncGuard)
from repro_torch.configs import qwen3_14b, recurrentgemma_9b
from repro_torch.models import model_init, transformer
from repro_torch.quant.qconfig import QConfig
from repro_torch.serving import ContinuousBatcher, Request, SpecConfig
from repro_torch.serving.decode import GenerateConfig
from repro_torch.testing import one_torch_thread, sync_budget_guard  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
COPIES = ("tolist", "cpu", "to")


# --------------------------------------------------------------------------
# mechanics
# --------------------------------------------------------------------------
class TestGuardMechanics:
    def test_counts_each_read_once(self):
        x = torch.arange(10.0)
        with SyncGuard() as guard:
            x.sum().item()                 # 1
            int(x[3])                      # 2
            bool(x[2] > 1)                 # 3
            x.cpu().numpy()                # 4: the copy's numpy() is no read
            x.cpu().tolist()               # 5: nor is its tolist()
            x.to("cpu").tolist()           # 6: a move named to the host
            m = x > 3
            x[m]                           # 7: boolean-mask indexing
            m.nonzero(as_tuple=True)       # 8
            torch.unique(x)                # 9
            x.masked_select(m)             # 10
            torch.equal(x, x)              # 11: reads both inside the op
            torch.allclose(x, x)           # 12
            x.long().bincount()            # 13
            torch.nn.functional.one_hot(x.long())   # 14, 15: its min and max
            x[torch.tensor([1, 2])]        # integer indexing: no sync
            x.repeat_interleave(2)         # repeats known on the host: no sync
            x.shape, x.size(0), x.numel()  # host values: no sync
            x.to(torch.float64)            # a cast: no sync
            x.to(x.device)                 # a move to the device: no sync
            x.to("cpu", non_blocking=True)  # no wait
            torch.empty(10).copy_(x)       # host to host on the CPU
        assert guard.syncs == 15
        assert dict(guard.by_kind) == {
            "aten._local_scalar_dense": 5, "Tensor.cpu": 2, "Tensor.to": 1,
            "aten.index": 1, "aten.nonzero": 1, "aten._unique2": 1,
            "aten.masked_select": 1, "aten.equal": 1, "aten.allclose": 1,
            "aten.bincount": 1}
        assert guard.ops > 15
        assert set(guard.launches.values()) == {0}

    def test_reads_of_other_devices_are_not_syncs(self, monkeypatch):
        """With a card present only reads of the card's tensors count."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        x = torch.arange(4.0)
        with SyncGuard() as guard:
            x.sum().item()
            x.nonzero()
            x.cpu().tolist()
            x.to("cpu")
        assert guard.syncs == 0

    def test_copies_from_the_card_are_syncs(self):
        """The dispatched copies that only the card makes: a blocking
        ``_to_copy`` or ``copy_`` from another device into a host tensor
        (a meta tensor stands for the card's)."""
        dev, host = torch.empty(2, device="meta"), torch.empty(2)
        cpu = torch.device("cpu")
        to_copy, copy = torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default
        assert sync_guard._read("_to_copy", to_copy, (dev,), {"device": cpu}) is dev
        assert sync_guard._read("copy_", copy, (host, dev), {}) is dev
        for name, func, args, kwargs in [
                ("_to_copy", to_copy, (dev,), {"device": cpu, "non_blocking": True}),
                ("_to_copy", to_copy, (dev,), {"dtype": torch.float64}),
                ("_to_copy", to_copy, (host,), {"device": cpu}),
                ("copy_", copy, (host, dev, True), {}),
                ("copy_", copy, (dev, host), {}),
                ("copy_", copy, (host, host), {})]:
            assert sync_guard._read(name, func, args, kwargs) is None, (name, args, kwargs)

    def test_raises_over_budget(self):
        x = torch.arange(4.0)
        with pytest.raises(SyncBudgetExceeded, match="3 host syncs, budget is 2"):
            with SyncGuard(budget=2):
                for i in range(3):
                    x[i].item()
        with pytest.raises(SyncBudgetExceeded, match="budget is 1"):
            with SyncGuard(op_budget=1):
                x + 1
                x * 2
        with SyncGuard(budget=0, op_budget=2):
            x + 1

    def test_patches_restored_and_nested(self):
        x = torch.arange(4.0)
        before = {n: getattr(torch.Tensor, n) for n in COPIES}
        with pytest.raises(RuntimeError):
            with SyncGuard() as outer:
                x[0].item()
                with SyncGuard() as inner:
                    x[1].cpu()
                assert getattr(torch.Tensor, "cpu") is not before["cpu"]
                raise RuntimeError("leave the scope by an exception")
        assert (outer.syncs, inner.syncs) == (2, 1)
        assert {n: getattr(torch.Tensor, n) for n in COPIES} == before
        assert not any(n in torch.Tensor.__dict__ for n in COPIES)
        assert x.cpu() is x and x.to("cpu") is x

    @pytest.mark.sync_budget(1)
    def test_marker_counts_the_body(self):
        torch.arange(3).sum().item()

    def test_marker_enforces_budget(self, tmp_path):
        """A mini-suite run by pytest with the repo's markers, strictly:
        the test over its budget errors at its teardown (where the guard
        closes, as the reference's compile_budget does), the ones within
        pass, a function-scoped fixture's syncs not charged."""
        (tmp_path / "test_budget.py").write_text(textwrap.dedent("""
            import pytest
            import torch
            from repro_torch.testing import sync_budget_guard  # noqa: F401

            @pytest.mark.sync_budget(1)
            def test_within():
                torch.ones(2).sum().item()

            @pytest.mark.sync_budget(1)
            def test_over():
                torch.ones(2).sum().item()
                torch.ones(2).nonzero()

            @pytest.fixture
            def synced():
                return torch.ones(2).nonzero()

            @pytest.mark.sync_budget(1)
            @pytest.mark.parametrize("n", [2])
            def test_fixture_not_charged(synced, n):
                torch.ones(n).sum().item()
        """))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-p", "no:xdist", "-p", "no:randomly", "--strict-markers",
             "-c", str(ROOT / "pytest.ini"), "--rootdir", str(tmp_path),
             str(tmp_path / "test_budget.py")],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
        assert "3 passed, 1 error" in out.stdout, out.stdout + out.stderr
        assert "ERROR at teardown of test_over" in out.stdout
        assert "SyncBudgetExceeded" in out.stdout and "budget is 1" in out.stdout


# --------------------------------------------------------------------------
# the serving tick's budget
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen():
    cfg = qwen3_14b.smoke()
    return cfg, model_init(0, cfg, device="cpu")


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def drain(b, requests, per_forward=TICK_SYNCS_PER_FORWARD):
    """Run ``b`` over ``requests`` ((prompt, new tokens)), one SyncGuard
    a tick with the tick's budget, and hold every tick at exactly
    ``per_forward`` syncs per forward. Returns the ticks' (forwards,
    syncs, ops, counts, the widest row's blocks)."""
    for u, (p, n) in enumerate(requests):
        b.submit(Request(uid=u, prompt=p, max_new_tokens=n))
    ticks = []
    while b.queue or any(s.req is not None for s in b.slots):
        f0 = b.forward_calls
        # each tick runs at most two forwards (a recurrent engine's decode
        # and prefill sub-steps)
        with SyncGuard(budget=2 * per_forward) as guard:
            b.step()
        fwd = b.forward_calls - f0
        assert guard.syncs == per_forward * fwd, (guard.syncs, fwd, dict(guard.by_kind))
        assert set(guard.launches.values()) == {0}     # the plain paths on the CPU
        widest = max((len(s.blocks) for s in b.slots), default=0) if b.paged else 0
        ticks.append((fwd, guard.syncs, guard.ops, b.last_counts.tolist(), widest))
        assert len(ticks) < 500
    assert len(b.done) == len(requests) and not b.failed
    return ticks


def test_decode_sweep_across_live_widths(qwen):
    """One row decodes until its block count has crossed several pow-2
    boundaries (block 2: 1 -> 14 blocks): every tick 1 forward, 2 syncs,
    1 of each kind."""
    cfg, params = qwen
    b = ContinuousBatcher(params, cfg, batch_size=1, max_len=32, block_size=2,
                          num_blocks=20, device="cpu")
    ticks = drain(b, [(np.arange(2, 4, dtype=np.int32), 25)])
    assert [t[0] for t in ticks] == [1] * len(ticks) and len(ticks) == 25
    assert {t[4] for t in ticks} >= {1, 2, 4, 8, 13}


@pytest.mark.parametrize("budget", [4, 8, 16])
def test_chunk_size_sweep(qwen, budget):
    """Prefill chunks of every size a token budget gives, beside decode
    rows (mixed ticks): 2 syncs per tick."""
    cfg, params = qwen
    b = ContinuousBatcher(params, cfg, batch_size=2, max_len=64, block_size=16,
                          token_budget=budget, device="cpu")
    ticks = drain(b, [(p, 3) for p in _prompts(cfg.vocab_size, (5, 11, 23))])
    counts = [c for t in ticks for c in t[3]]
    assert any(1 < c for c in counts) and 1 in counts
    assert all(t[1] == TICK_SYNCS_PER_FORWARD for t in ticks)


@pytest.mark.parametrize("kind", ["int8-kv", "w8a8"])
def test_int8_engines_sweep(qwen, kind):
    """The int8-KV pool and the W8A8 tick (calibrated in the constructor,
    outside the guard) pay the fp tick's syncs: the W8A8 tick reads no
    scalar back (its activation ranges are python floats)."""
    cfg, params = qwen
    kw = dict(kv_int8=True) if kind == "int8-kv" else dict(qconfig=QConfig())
    b = ContinuousBatcher(params, cfg, batch_size=2, max_len=32, block_size=2,
                          num_blocks=30, token_budget=8, device="cpu", **kw)
    assert b.kv_int8
    drain(b, [(p, 6) for p in _prompts(cfg.vocab_size, (5, 11))])


class _CycleDrafter:
    """Draft lengths cycling 0..7, so successive ticks verify every Tq in
    1..8."""
    calls = 0

    def propose(self, prompt, generated, k):
        self.calls += 1
        return [1] * min((self.calls - 1) % 8, k)


def test_spec_sweep_across_draft_lengths(qwen):
    cfg, params = qwen
    b = ContinuousBatcher(params, cfg, batch_size=1, max_len=64, block_size=64,
                          num_blocks=4, spec=SpecConfig(k=7), device="cpu")
    b._drafter = _CycleDrafter()
    ticks = drain(b, [(np.arange(2, 4, dtype=np.int32), 30)])
    assert {t[3][0] for t in ticks} >= set(range(1, 9))     # every Tq verified


def test_spec_with_accepted_drafts(qwen):
    """Repetitive prompts make the n-gram drafter's drafts accepted: the
    verifying tick pays the same 2 syncs."""
    cfg, params = qwen
    b = ContinuousBatcher(params, cfg, batch_size=2, max_len=64, block_size=16,
                          token_budget=8, spec=SpecConfig(k=3), device="cpu")
    drain(b, [(np.array([2, 9] * 6, np.int32), 8), (np.array([3, 5] * 5, np.int32), 8)])
    assert b.spec_accepted > 0


def test_sampling_engine_pays_the_key_check(qwen):
    """Temperature sampling keys each row through PRNGKey, whose range
    check is one more sync a forward (a reasoned R001 suppression)."""
    cfg, params = qwen
    b = ContinuousBatcher(params, cfg, batch_size=2, max_len=32, block_size=4,
                          token_budget=8, gen=GenerateConfig(temperature=0.7, top_k=8),
                          device="cpu")
    drain(b, [(p, 4) for p in _prompts(cfg.vocab_size, (6, 9))],
          per_forward=SAMPLED_TICK_SYNCS_PER_FORWARD)


def test_recurrent_substeps():
    """recurrentgemma's ticks split into decode and uniform prefill
    sub-steps, each a forward: 2 syncs per sub-step (the ring write's
    nonzero and the sub-step's .cpu())."""
    cfg = recurrentgemma_9b.smoke()
    params = model_init(0, cfg, device="cpu")
    b = ContinuousBatcher(params, cfg, batch_size=2, max_len=64, block_size=16,
                          token_budget=8, device="cpu")
    ticks = drain(b, [(p, 4) for p in _prompts(cfg.vocab_size, (5, 11))])
    assert any(t[0] == 2 for t in ticks)


@pytest.fixture(scope="module")
def one_tick_engine(qwen):
    cfg, params = qwen
    b = ContinuousBatcher(params, cfg, batch_size=2, max_len=32, block_size=16,
                          device="cpu")
    for u, p in enumerate(_prompts(cfg.vocab_size, (5, 7))):
        b.submit(Request(uid=u, prompt=p, max_new_tokens=2))
    return b


@pytest.mark.sync_budget(TICK_SYNCS_PER_FORWARD)
def test_marked_tick(one_tick_engine):
    """The marker on a real tick (the engine is built by a module
    fixture, before the guard starts)."""
    one_tick_engine.step()
    assert one_tick_engine.forward_calls == 1


def test_added_sync_trips_guard(qwen, monkeypatch):
    """Acceptance demo: one extra .item() in the forward (here in the
    paged write's targets) and the same decode the budget holds fails."""
    real = transformer._paged_targets

    def with_extra_read(table, tpos, act_tok, nb, bs):
        int(tpos.max().item())
        return real(table, tpos, act_tok, nb, bs)

    monkeypatch.setattr(transformer, "_paged_targets", with_extra_read)
    cfg, params = qwen
    b = ContinuousBatcher(params, cfg, batch_size=1, max_len=32, block_size=2,
                          num_blocks=20, device="cpu")
    b.submit(Request(uid=0, prompt=np.arange(2, 4, dtype=np.int32), max_new_tokens=4))
    with pytest.raises(SyncBudgetExceeded, match="'aten._local_scalar_dense': 1"):
        with SyncGuard(budget=TICK_SYNCS_PER_FORWARD):
            b.step()
