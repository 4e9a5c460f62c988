"""Deterministic fault injection + invariant auditing for the engine
(port of ``repro.serving.chaos``; numpy over the port's batcher).

The scheduler's failure handling (transient-fault stalling, bounded
swap-in retry, priority-ordered shedding) is worthless if it only runs on
the happy path. This module makes faults *reproducible*: a ``FaultPlan``
is a seeded schedule of misbehaviour — allocation failures at chosen
ticks, spurious preemption storms, admission floods of junk requests,
swap-in denial windows — and ``ChaosHarness`` replays it against a live
``ContinuousBatcher``, running the full block-accounting audit after
every step. The contract under chaos:

  * **never a crash** — every injected fault is absorbed by policy
    (retry, stall, degrade to recompute, or shed in priority order);
  * **never a corrupted row** — surviving requests produce exactly the
    tokens an unperturbed engine would (position-keyed sampling +
    quantize-on-write make this checkable bitwise);
  * **never a leaked block** — ``batcher.audit()`` passes after every
    tick: each block is exactly one of free / owned-by-a-live-row, block
    tables mirror slot state, swap-byte accounting balances.

Fault taxonomy (matching the scheduler's degradation order):

  ``alloc_fail``      transient: allocator refuses although blocks exist.
                      Engine must stall that row and retry next tick —
                      *not* preempt (the pool isn't actually full) — and
                      only shed (lowest priority first) if the fault
                      persists past its streak budget.
  ``preempt_storm``   spurious preemptions of running rows. Victims must
                      resume (swap or recompute) token-exact.
  ``flood``           bursts of junk admissions at low priority. Must not
                      starve higher tiers or corrupt accounting.
  ``swap_deny``       swap-in refusals. Engine retries a bounded number
                      of times then degrades to recompute-resume.
  ``prefix_storm``    bursts of near-identical prompts (a shared system
                      prefix + tiny random tails) followed by cancel
                      bursts of roughly half the storm one tick later —
                      the hostile pattern for the prefix cache: heavy
                      trie sharing, refcounts spiking and collapsing,
                      copy-on-write divergence and LRU eviction all
                      racing the other faults. The refcount audit
                      ("every block's refcount equals its owner count
                      across tables + trie + sampling groups") must hold
                      after every tick.

The plans and the harness's own draws are the reference's, in its
order: the same plan against the same engine gives the reference's event
log. Run the seeded smoke on the card, or on the CPU::

    PYTHONPATH=src python -m repro_torch.serving.chaos --smoke
    PYTHONPATH=src python -m repro_torch.serving.chaos --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.serving.scheduler import ContinuousBatcher, Request


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, fully explicit schedule of faults over ``ticks`` engine
    steps. Instances are plain data — printable, diffable, replayable."""
    seed: int
    ticks: int
    alloc_fail: frozenset = frozenset()     # ticks where alloc is denied
    preempt_storm: Tuple[Tuple[int, int], ...] = ()   # (tick, n_victims)
    flood: Tuple[Tuple[int, int], ...] = ()           # (tick, n_junk)
    swap_deny: frozenset = frozenset()      # ticks where swap-in is denied
    # (tick, n) bursts of near-identical prompts; ~half of each burst is
    # cancelled one tick later (defaults empty so pre-existing plans are
    # byte-identical to before this field existed)
    prefix_storm: Tuple[Tuple[int, int], ...] = ()

    @staticmethod
    def random(seed: int, ticks: int = 40,
               p_alloc: float = 0.15, p_storm: float = 0.10,
               p_flood: float = 0.08, p_deny: float = 0.15,
               p_prefix: float = 0.0) -> "FaultPlan":
        """Draw a plan from a seeded RNG. Distinct seeds give distinct
        plans; the same seed always gives the same plan (and plans drawn
        with ``p_prefix=0`` are identical to pre-prefix-storm plans: the
        extra draw only happens when the probability is nonzero)."""
        rng = np.random.default_rng(seed)
        alloc: Set[int] = set()
        storms: List[Tuple[int, int]] = []
        floods: List[Tuple[int, int]] = []
        deny: Set[int] = set()
        prefix: List[Tuple[int, int]] = []
        for t in range(ticks):
            r = rng.random(4)
            if r[0] < p_alloc:
                # faults arrive in short bursts, like a real flaky resource
                for d in range(int(rng.integers(1, 4))):
                    alloc.add(t + d)
            if r[1] < p_storm:
                storms.append((t, int(rng.integers(1, 3))))
            if r[2] < p_flood:
                floods.append((t, int(rng.integers(1, 4))))
            if r[3] < p_deny:
                deny.add(t)
            if p_prefix > 0 and float(rng.random()) < p_prefix:
                prefix.append((t, int(rng.integers(2, 6))))
        return FaultPlan(seed=seed, ticks=ticks,
                         alloc_fail=frozenset(alloc),
                         preempt_storm=tuple(storms),
                         flood=tuple(floods),
                         swap_deny=frozenset(deny),
                         prefix_storm=tuple(prefix))


class FaultyAllocator:
    """Wraps a ``BlockAllocator``; on fault ticks every ``alloc`` is
    denied (returns None) while the blocks remain genuinely available —
    exactly the "spurious failure" the scheduler must treat as transient.
    All other methods delegate, so the audit sees the real free list."""

    def __init__(self, inner):
        self.inner = inner
        self.failing = False
        self.denied = 0

    @property
    def num_blocks(self) -> int:
        return self.inner.num_blocks

    @property
    def available(self) -> int:
        return self.inner.available

    def alloc(self, n: int):
        if self.failing and n > 0:
            self.denied += 1
            return None
        return self.inner.alloc(n)

    def free(self, blocks) -> None:
        self.inner.free(blocks)

    def acquire(self, blocks) -> None:
        # reference bumps on live blocks never fail: only fresh
        # allocation is the flaky resource being modeled
        self.inner.acquire(blocks)

    def release(self, blocks) -> None:
        self.inner.release(blocks)

    def refcount(self, block: int) -> int:
        return self.inner.refcount(block)

    def free_list(self):
        return self.inner.free_list()


class ChaosHarness:
    """Replays a ``FaultPlan`` against a batcher: per tick, arms the
    faulty allocator, fires preemption storms / floods due this tick,
    steps the engine, then runs the full allocator audit. Any crash or
    audit failure propagates — the test contract is that none occurs."""

    JUNK_UID0 = 1_000_000            # flood uids, outside any trace

    def __init__(self, batcher: ContinuousBatcher, plan: FaultPlan,
                 vocab: int = 64):
        self.b = batcher
        self.plan = plan
        self.vocab = vocab
        self.rng = np.random.default_rng(plan.seed ^ 0x5EED)
        self.tick = 0
        self._junk = ChaosHarness.JUNK_UID0
        self.events: List[str] = []
        if batcher.paged:
            batcher.allocator = FaultyAllocator(batcher.allocator)
        batcher._swap_in_gate = \
            lambda req: self.tick not in self.plan.swap_deny
        self._storms: Dict[int, int] = dict(plan.preempt_storm)
        self._floods: Dict[int, int] = dict(plan.flood)
        self._prefix_storms: Dict[int, int] = dict(plan.prefix_storm)
        # one hostile "system prompt" per harness: long enough to span
        # several blocks so storm prompts share real trie state
        plen = 3 * batcher.block_size if batcher.paged else 12
        plen = min(plen, max(1, batcher.L // 2))
        self._prefix = self.rng.integers(4, vocab, size=plen) \
            .astype(np.int32)
        self._cancel_next: List[int] = []   # storm uids due for cancelling

    def _storm(self, n: int) -> None:
        live = [i for i, s in enumerate(self.b.slots) if s.req is not None]
        self.rng.shuffle(live)
        for i in live[:n]:
            if self.b.slots[i].req is None:     # freed by an earlier victim
                continue
            self.events.append(f"t{self.tick} preempt slot{i} "
                               f"uid{self.b.slots[i].req.uid}")
            self.b.preempt_slot(i)

    def _prefix_storm_burst(self, n: int) -> None:
        """Submit ``n`` near-identical prompts (shared prefix + a 0-3
        token random tail, occasionally n>1 parallel sampling) and queue
        roughly half of them for a cancel burst next tick — admission
        sharing, CoW divergence, refcount churn and mid-flight teardown
        all at once."""
        burst: List[int] = []
        for _ in range(n):
            tail_len = int(self.rng.integers(0, 4))
            tail = self.rng.integers(4, self.vocab, size=tail_len)
            prompt = np.concatenate([self._prefix,
                                     tail.astype(np.int32)])
            fanout = int(self.rng.integers(1, 3))    # sometimes n=2
            self.b.submit(Request(uid=self._junk,
                                  prompt=prompt,
                                  max_new_tokens=int(self.rng.integers(1, 5)),
                                  priority=int(self.rng.integers(0, 2)),
                                  n=fanout))
            self.events.append(f"t{self.tick} prefix_storm uid{self._junk} "
                               f"n={fanout}")
            burst.append(self._junk)
            self._junk += 1
        self.rng.shuffle(burst)
        self._cancel_next.extend(burst[:len(burst) // 2])

    def _flood(self, n: int) -> None:
        for _ in range(n):
            plen = int(self.rng.integers(1, 9))
            prompt = self.rng.integers(4, self.vocab, size=plen)
            self.b.submit(Request(uid=self._junk,
                                  prompt=np.asarray(prompt, np.int32),
                                  max_new_tokens=int(self.rng.integers(1, 5)),
                                  priority=-1))
            self.events.append(f"t{self.tick} flood uid{self._junk}")
            self._junk += 1

    def step(self, now: Optional[float] = None) -> None:
        t = self.tick
        if self.b.paged:
            self.b.allocator.failing = t in self.plan.alloc_fail
        if self._cancel_next:
            for uid in self._cancel_next:
                if self.b.cancel(uid):
                    self.events.append(f"t{t} cancel uid{uid}")
            self._cancel_next = []
        if t in self._storms:
            self._storm(self._storms[t])
        if t in self._floods:
            self._flood(self._floods[t])
        if t in self._prefix_storms:
            self._prefix_storm_burst(self._prefix_storms[t])
        self.b.step(now=now)
        self.b.audit()
        self.tick += 1

    def run(self, drain_ticks: int = 400) -> None:
        """Run the plan's ticks, then disarm all faults and drain."""
        for _ in range(self.plan.ticks):
            self.step()
        if self.b.paged:
            self.b.allocator.failing = False
        self.b._swap_in_gate = None
        for _ in range(drain_ticks):
            if not self.b.queue and \
                    all(s.req is None for s in self.b.slots):
                return
            self.b.step()
            self.b.audit()
        raise RuntimeError("engine failed to drain after chaos plan "
                           f"seed={self.plan.seed}")


# the smoke's engine: a small int8-KV pool that preemption, swap, shedding
# and the prefix cache all reach within a plan's 30 ticks
SMOKE_ENGINE = dict(batch_size=4, max_len=64, token_budget=48, paged=True,
                    num_blocks=24, block_size=8, kv_int8=True,
                    swap_break_even_tokens=16, on_pool_exhausted="shed",
                    prefix_cache=True, debug_audit=True)


def smoke_plans() -> List[FaultPlan]:
    """The smoke's six plans: ``FaultPlan.random(seed, ticks=30)`` for
    seeds 0-4, then the prefix-cache hostile plan (prompt bursts sharing a
    system prefix + cancel bursts, on top of a light dose of the other
    faults)."""
    plans = [FaultPlan.random(seed, ticks=30) for seed in range(5)]
    plans.append(FaultPlan.random(5, ticks=30, p_alloc=0.10,
                                  p_storm=0.08, p_flood=0.05,
                                  p_deny=0.10, p_prefix=0.35))
    return plans


def smoke_requests(seed: int) -> List[Request]:
    """The ten requests the smoke submits before plan ``seed``."""
    rng = np.random.default_rng(1234 + seed)
    reqs = []
    for uid in range(10):
        plen = int(rng.integers(2, 24))
        reqs.append(Request(
            uid=uid,
            prompt=rng.integers(4, 64, size=plen).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 9)),
            priority=int(rng.integers(0, 3))))
    return reqs


def _smoke(device="cuda") -> int:
    """Six seeded plans against a tiny paged int8-KV engine with the
    prefix cache live (5 general fault plans + 1 prefix-storm plan) on
    ``device``; exits nonzero on any crash, refcount-audit violation, or
    failed drain."""
    from repro_torch.models.transformer import ModelConfig, model_init

    cfg = ModelConfig(name="tiny", n_layers=2, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=64, vocab_size=64, pos="rope",
                      max_seq_len=64, scan_layers=False, remat=False,
                      mlp_kind="swiglu", norm="rmsnorm")
    params = model_init(0, cfg, device=device)
    for seed, plan in enumerate(smoke_plans()):
        b = ContinuousBatcher(params, cfg, **SMOKE_ENGINE, device=device)
        for req in smoke_requests(seed):
            b.submit(req)
        h = ChaosHarness(b, plan)
        h.run()
        kind = "prefix-storm" if plan.prefix_storm else "general"
        print(f"plan seed={seed} ({kind}): done={len(b.done)} "
              f"failed={len(b.failed)} "
              f"denied_allocs={b.allocator.denied} "
              f"prefix_hits={b.prefix_cache.hits} "
              f"cow={b.cow_copies} evictions={b.prefix_cache.evictions} "
              f"events={len(h.events)} audit=clean")
        if plan.prefix_storm and b.prefix_cache.hits == 0:
            print("FAIL: prefix-storm plan produced no trie hits")
            return 1
    print("chaos smoke: 6 plans (incl. prefix-storm), zero crashes, "
          "zero refcount-audit violations")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="run 6 seeded fault plans against a tiny engine")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda; cpu)")
    args = ap.parse_args()
    if args.smoke:
        return _smoke(args.device)
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
