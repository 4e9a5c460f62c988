"""Open-loop workload harness: seeded traces + a virtual-clock runner
(port of ``repro.serving.workload``; numpy over the port's batcher).

The throughput benchmark is *closed-loop*: it submits N requests and runs
the engine to empty, so the engine is never actually under pressure —
arrivals wait politely for capacity, and "tokens/sec at batch B" says
nothing about what happens when traffic does not cooperate. Real traffic
is *open-loop*: requests arrive on their own schedule (bursty Poisson
inter-arrivals), with heavy-tailed prompt/output lengths, in priority
tiers with per-request deadlines, and some of them are cancelled midway.
Under open-loop load the headline metric stops being throughput and
becomes **goodput**: tokens delivered by requests that finished *inside
their SLO* — a request completed after its deadline is wasted work, and
an engine that never sheds serves everyone late.

Three pieces:

  * ``generate_trace(WorkloadConfig)`` — a deterministic-per-seed list of
    ``TraceEntry`` (arrival time, tier, priority, prompt, output length,
    deadline, optional cancellation time). Prompt/output lengths are
    clipped lognormals (heavy tails: a few long stragglers dominate pool
    pressure); deadlines derive from the tier's TTFT + per-token SLOs.
    The numpy draws are the reference's, in its order, so a trace is
    bitwise the reference's trace of the same config.
  * ``run_workload(batcher, trace, ...)`` — drives ``ContinuousBatcher``
    through the trace on a **virtual clock**: each tick costs
    ``TickCostModel.cost(tokens processed)`` virtual seconds (wall-clock
    mode is available for real timing, but the virtual clock makes
    every run bit-deterministic per seed — tests can assert on it).
    Arrivals are submitted when the clock passes them, cancellations
    issued when due, and the engine's own SLO machinery (deadline
    expiry, infeasible shedding, priority admission) does the rest.
    With ``wall_clock=True`` a tick costs its ``time.perf_counter()``
    span; the port's tick ends in one device-to-host copy, so the span
    includes the device's work. Such timings mean something only on an
    otherwise idle card.
  * ``WorkloadReport`` — goodput (global and per tier), delivered tokens,
    TTFT p50/p99 per tier, p99 decode-tick stall (the cost of ticks in
    which at least one row was decoding — the inter-token latency a user
    actually observes), per-tier TPOT (time per banked output token, from
    each done request's own first-token->finish span), and per-status
    failure counts.

Accounting under speculative decoding: a tick is no longer one token per
decode row. The runner charges the clock with the engine's
``last_tick_tokens`` — FED tokens, drafts included, because that is the
compute the forward actually paid — but throughput/TPOT numerators use
*banked* tokens (``last_tick_new_tokens`` per tick; request outputs at
report time), so a rejected draft makes the engine look slower, never
faster. Goodput already counts ``req.output`` lengths, which are banked
by construction.

The runner never reaches into the engine's scheduling decisions — it only
submits, cancels, and advances the clock — so the same trace can drive
dense/paged/int8 engines and the reports are directly comparable.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.scheduler import ContinuousBatcher, Request


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One priority tier of the traffic mix. ``ttft_slo``/``tpot_slo``
    define each request's deadline: arrival + ttft_slo + output_len *
    tpot_slo (time to first token, then a per-token drip rate)."""
    name: str
    weight: float          # share of requests drawn from this tier
    priority: int          # ContinuousBatcher admission priority
    ttft_slo: float        # virtual seconds allowed to the first token
    tpot_slo: float        # virtual seconds allowed per output token


DEFAULT_TIERS: Tuple[TierSpec, ...] = (
    TierSpec("interactive", weight=0.5, priority=2, ttft_slo=0.5,
             tpot_slo=0.05),
    TierSpec("standard", weight=0.35, priority=1, ttft_slo=2.0,
             tpot_slo=0.2),
    TierSpec("batch", weight=0.15, priority=0, ttft_slo=20.0, tpot_slo=2.0),
)


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Seeded open-loop trace parameters. Everything downstream of
    ``seed`` is deterministic: same config -> identical trace, and (with
    the virtual clock) identical run report."""
    seed: int = 0
    n_requests: int = 64
    rate: float = 20.0             # mean arrivals / virtual second (Poisson)
    vocab: int = 64
    prompt_log_mu: float = math.log(12.0)   # lognormal prompt lengths
    prompt_log_sigma: float = 0.8
    prompt_max: int = 96
    out_log_mu: float = math.log(8.0)       # lognormal output lengths
    out_log_sigma: float = 0.7
    out_max: int = 32
    cancel_frac: float = 0.0       # fraction of requests cancelled mid-SLO
    # shared-prefix traffic (prefix-cache workloads): with probability
    # ``prefix_frac`` a request's prompt is one fixed per-trace "system
    # prompt" of ``prefix_len`` tokens followed by its own drawn body —
    # the overlap ratio knob the sharing benchmark sweeps. Defaults keep
    # traces byte-identical to pre-knob seeds (the extra RNG draws only
    # happen when the knob is on).
    prefix_len: int = 0
    prefix_frac: float = 0.0
    tiers: Tuple[TierSpec, ...] = DEFAULT_TIERS


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    uid: int
    arrival: float
    tier: str
    priority: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline: float
    cancel_at: Optional[float] = None

    def request(self) -> Request:
        """A fresh Request for this entry (entries are reusable across
        runs; Requests are mutated by the engine)."""
        return Request(uid=self.uid, prompt=self.prompt.copy(),
                       max_new_tokens=self.max_new_tokens,
                       priority=self.priority, deadline=self.deadline)


def _clipped_lognormal(rng: np.random.Generator, mu: float, sigma: float,
                       hi: int) -> int:
    return int(np.clip(round(float(rng.lognormal(mu, sigma))), 1, hi))


def generate_trace(wcfg: WorkloadConfig) -> List[TraceEntry]:
    """Deterministic-per-seed open-loop trace (sorted by arrival)."""
    if not wcfg.tiers:
        raise ValueError("WorkloadConfig.tiers must not be empty")
    rng = np.random.default_rng(wcfg.seed)
    w = np.asarray([t.weight for t in wcfg.tiers], np.float64)
    w = w / w.sum()
    share = wcfg.prefix_len > 0 and wcfg.prefix_frac > 0
    shared_prefix = rng.integers(4, wcfg.vocab, size=wcfg.prefix_len) \
        .astype(np.int32) if share else None
    t = 0.0
    entries: List[TraceEntry] = []
    for uid in range(wcfg.n_requests):
        t += float(rng.exponential(1.0 / wcfg.rate))
        tier = wcfg.tiers[int(rng.choice(len(wcfg.tiers), p=w))]
        plen = _clipped_lognormal(rng, wcfg.prompt_log_mu,
                                  wcfg.prompt_log_sigma, wcfg.prompt_max)
        olen = _clipped_lognormal(rng, wcfg.out_log_mu,
                                  wcfg.out_log_sigma, wcfg.out_max)
        prompt = rng.integers(4, wcfg.vocab, size=plen).astype(np.int32)
        if share and float(rng.random()) < wcfg.prefix_frac:
            prompt = np.concatenate([shared_prefix, prompt])
        deadline = t + tier.ttft_slo + olen * tier.tpot_slo
        cancel_at = None
        if wcfg.cancel_frac > 0 and float(rng.random()) < wcfg.cancel_frac:
            # cancel somewhere inside the request's SLO window — the
            # client gave up (or navigated away) while being served
            cancel_at = t + float(rng.uniform(0.2, 0.9)) * (deadline - t)
        entries.append(TraceEntry(uid=uid, arrival=t, tier=tier.name,
                                  priority=tier.priority, prompt=prompt,
                                  max_new_tokens=olen, deadline=deadline,
                                  cancel_at=cancel_at))
    return entries


@dataclasses.dataclass(frozen=True)
class TickCostModel:
    """Virtual cost of one engine tick: a fixed dispatch overhead plus a
    per-processed-token term. Deliberately simple — the point is a
    *deterministic, monotone-in-work* clock, not a hardware model; wall
    mode exists for real timing."""
    base: float = 2e-3
    per_token: float = 5e-4

    def cost(self, tokens: int) -> float:
        return self.base + self.per_token * max(int(tokens), 0)


def _pct(xs: List[float], q: float) -> float:
    if not xs:
        return float("nan")
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(math.ceil(q * len(ys))) - 1)]


@dataclasses.dataclass
class TierReport:
    name: str
    offered: int = 0               # requests in the trace
    done: int = 0                  # completed (any time)
    in_slo: int = 0                # completed by their deadline
    failed: Dict[str, int] = dataclasses.field(default_factory=dict)
    goodput_tokens: int = 0        # tokens of in-SLO completions
    delivered_tokens: int = 0      # all tokens handed back (incl. partial)
    ttft: List[float] = dataclasses.field(default_factory=list)
    # per-request time-per-output-token: (finish - first_token)/(n - 1)
    # for done requests with >= 2 tokens. Derived from request stamps,
    # not tick counts, so a speculative tick banking several tokens
    # lowers TPOT exactly as much as it should
    tpot: List[float] = dataclasses.field(default_factory=list)

    @property
    def ttft_p50(self) -> float:
        return _pct(self.ttft, 0.50)

    @property
    def ttft_p99(self) -> float:
        return _pct(self.ttft, 0.99)

    @property
    def tpot_p50(self) -> float:
        return _pct(self.tpot, 0.50)

    @property
    def tpot_p99(self) -> float:
        return _pct(self.tpot, 0.99)


@dataclasses.dataclass
class WorkloadReport:
    duration: float
    ticks: int
    goodput_tokens: int
    delivered_tokens: int
    tick_p50: float
    stall_p99: float               # p99 cost of ticks with a decoding row
    tiers: Dict[str, TierReport]
    # decode-phase aggregates: tokens BANKED on ticks that had a decoding
    # row, and those ticks' total cost — decode_time/decode_tokens is the
    # engine-level TPOT (equals stall-per-token only when every tick
    # banks exactly 1 token per row; speculation breaks that identity,
    # which is why this is tracked in tokens, not ticks)
    decode_tokens: int = 0
    decode_time: float = 0.0

    @property
    def goodput_tok_s(self) -> float:
        return self.goodput_tokens / self.duration if self.duration else 0.0

    @property
    def decode_tpot(self) -> float:
        return self.decode_time / self.decode_tokens \
            if self.decode_tokens else float("nan")

    def table(self) -> str:
        """CSV-ish per-tier summary (the benchmark prints this)."""
        lines = ["tier,offered,done,in_slo,shed,goodput_tok,"
                 "ttft_p50,ttft_p99,tpot_p50"]
        for tr in self.tiers.values():
            shed = sum(tr.failed.values())
            lines.append(f"{tr.name},{tr.offered},{tr.done},{tr.in_slo},"
                         f"{shed},{tr.goodput_tokens},{tr.ttft_p50:.3f},"
                         f"{tr.ttft_p99:.3f},{tr.tpot_p50:.4f}")
        lines.append(f"TOTAL goodput {self.goodput_tokens} tok "
                     f"({self.goodput_tok_s:.1f} tok/s virtual), delivered "
                     f"{self.delivered_tokens} tok, stall_p99 "
                     f"{self.stall_p99 * 1e3:.2f} ms, decode_tpot "
                     f"{self.decode_tpot * 1e3:.2f} ms/tok over "
                     f"{self.ticks} ticks")
        return "\n".join(lines)


def run_workload(batcher: ContinuousBatcher, trace: List[TraceEntry],
                 cost: TickCostModel = TickCostModel(),
                 wall_clock: bool = False,
                 max_ticks: int = 100_000) -> WorkloadReport:
    """Drive the engine through the trace open-loop. The runner owns the
    clock: it submits arrivals when the clock passes them, issues due
    cancellations, steps the engine with ``now`` and charges each tick
    ``cost.cost(tokens processed)`` (or measured wall time). When the
    engine is fully idle it jumps straight to the next arrival. The
    batcher is expected to be freshly constructed (its ``done``/``failed``
    lists become the report)."""
    pending = sorted(trace, key=lambda e: (e.arrival, e.uid))
    by_uid = {e.uid: e for e in trace}
    cancels = sorted(((e.cancel_at, e.uid) for e in trace
                      if e.cancel_at is not None))
    t = pending[0].arrival if pending else 0.0
    k = 0                      # next pending arrival
    c = 0                      # next cancellation
    ticks = 0
    tick_costs: List[float] = []
    stalls: List[float] = []
    decode_tokens = 0
    decode_time = 0.0
    while ticks < max_ticks:
        while k < len(pending) and pending[k].arrival <= t:
            batcher.submit(pending[k].request())
            k += 1
        while c < len(cancels) and cancels[c][0] <= t:
            batcher.cancel(cancels[c][1])
            c += 1
        live = any(s.req is not None for s in batcher.slots)
        if not live and not batcher.queue:
            if k >= len(pending):
                break                         # drained
            t = max(t, pending[k].arrival)    # idle: jump to next arrival
            continue
        decoding = any(s.req is not None and s.prefill is None
                       for s in batcher.slots)
        t0 = time.perf_counter()
        batcher.step(now=t)
        # the clock is charged for FED tokens (speculative drafts
        # included — the forward computed them whether or not they were
        # accepted); banked tokens feed the TPOT numerator below
        dt = time.perf_counter() - t0 if wall_clock \
            else cost.cost(batcher.last_tick_tokens)
        ticks += 1
        tick_costs.append(dt)
        if decoding:
            stalls.append(dt)
            decode_tokens += int(batcher.last_tick_new_tokens)
            decode_time += dt
        t += dt

    tiers: Dict[str, TierReport] = {}
    for e in trace:
        if e.tier not in tiers:
            tiers[e.tier] = TierReport(name=e.tier)
        tiers[e.tier].offered += 1
    goodput = delivered = 0
    for req in batcher.done:
        e = by_uid[req.uid]
        tr = tiers[e.tier]
        n = int(len(req.output))
        tr.done += 1
        tr.delivered_tokens += n
        delivered += n
        if req.finish_time is not None and req.finish_time <= e.deadline:
            tr.in_slo += 1
            tr.goodput_tokens += n
            goodput += n
        if req.first_token_time is not None:
            tr.ttft.append(req.first_token_time - e.arrival)
            if req.finish_time is not None and n >= 2:
                tr.tpot.append(
                    (req.finish_time - req.first_token_time) / (n - 1))
    for req in batcher.failed:
        e = by_uid.get(req.uid)
        if e is None:
            continue                      # chaos flood junk, not traced
        tr = tiers[e.tier]
        tr.failed[req.status] = tr.failed.get(req.status, 0) + 1
        n = 0 if req.output is None else int(len(req.output))
        tr.delivered_tokens += n
        delivered += n
    duration = (t - pending[0].arrival) if pending else 0.0
    return WorkloadReport(duration=duration, ticks=ticks,
                          goodput_tokens=goodput,
                          delivered_tokens=delivered,
                          tick_p50=_pct(tick_costs, 0.50),
                          stall_p99=_pct(stalls, 0.99),
                          tiers=tiers,
                          decode_tokens=decode_tokens,
                          decode_time=decode_time)
