"""Token-budget continuous-batching scheduler over one fused mixed step
(port of ``repro.serving.scheduler``).

Every engine tick assembles ONE forward of up to ``token_budget`` tokens:
decoding rows contribute 1 token each (1 + drafts under speculation),
admitted-but-unfinished prompts contribute prefill chunks, and every row
sits at its own position. Two KV-cache backends, selected by ``paged``:

  * paged (the default here) — a global block pool per layer plus
    per-row block tables (``init_paged_cache``); ``BlockAllocator`` is the
    host-side refcounted free list. When the pool is exhausted and no row
    can advance, the most recently admitted stalled row is preempted —
    swapped out to host memory when its context is long enough
    (``swap_break_even_tokens``), else re-queued for recompute-resume.
  * dense (``paged=False``, the reference's default) — every slot row
    reserves ``max_len`` positions (``init_cache``), written by the masked
    per-token scatter; no allocator, no tables, no swap, no prefix cache
    (``audit()`` has nothing to check). Speculation is allowed on
    all-``attn`` configs: a rejected draft's write is causally hidden and
    overwritten, as in a paged pool.

Carried over from the JAX engine: (priority, deadline, arrival)
admission with a free-block watermark, SLO deadlines/timeouts with
infeasibility shedding and a prefill budget, swap and recompute
preemption, transient allocator faults with bounded shedding, the prefix
cache with copy-on-write, ``Request(n=k)`` parallel sampling,
speculative decoding and ``audit()``. The token at position p is a pure
function of (request seed, p) (see ``serving.decode``), so preemption,
chunking, prefix sharing and speculation are all bitwise invisible.

W8A8 serving: ``qconfig=`` calibrates static per-site activation ranges
once at construction (``_calibrate_engine``: a few synthetic batches
through the fp model in 'collect' mode, then ``use_int8_runtime``, which
leaves the ranges as python floats), attaches int8 weights beside the fp
ones (``attach_int8_weights``) and runs every matmul weight the reference
caches (attention and MLP linears, the Griffin block's, the xLSTM blocks'
projections) through the ``int8_matmul`` kernel, on every block kind;
``kv_int8`` defaults to on with it in a paged engine, as in the
reference, and quantizes only global-attention pools (a ring or a
recurrent state stays fp). Nothing in the tick reads a range back from
the device. The int8 GEMMs return f32, so a bf16 model's conv histories
turn f32 after the first tick, as in the reference.

Ring (``local_attn``) and recurrent (``griffin``, ``mlstm``, ``slstm``)
layers keep per-row ("batch-led") state beside the shared pools: the
ring's K/V and position ids, the recurrences' h / cell and conv history.
Admission resets a slot's rows
to a fresh template, and swap preemption carries them to the host and
back. A recurrence has no per-token write index to mask, so a config
with recurrent blocks cannot run ragged rows: its tick is a decode
sub-step (T = 1) followed by a uniform prefill sub-step in which every
prefilling row takes the same chunk length, fed at its exact length.
Such configs refuse ``spec=`` and ``prefix_cache=True`` as the reference
does (a ring or recurrent write cannot be hidden or shared), and run
``Request(n=k)`` branches as independent requests.

A config of ``input_kind`` "embeds" has no token path and raises
``ValueError``; a "mixed" one serves text prompts through its token
embeddings. Host bookkeeping is
numpy; the tick's tensors live on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    ModelConfig,
    check_supported,
    copy_pool_blocks,
    init_cache,
    init_paged_cache,
    model_apply,
    paged_entries,
    row_leaves,
)
from repro_torch.quant.int8_weights import attach_int8_weights
from repro_torch.quant.ptq import calibrate
from repro_torch.quant.qconfig import NO_QUANT, QConfig, QuantContext
from repro_torch.random import PRNGKey, fold_in, randint
from repro_torch.serving.decode import (
    GenerateConfig,
    make_mixed_step,
    make_spec_step,
)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.speculate import NGramDrafter, SpecConfig

_POOL_LEAVES = ("k", "v", "k_scale", "v_scale")
# block kinds whose state has no per-token write index
_RECURRENT_KINDS = ("griffin", "mlstm", "slstm")


class AllocatorAuditError(RuntimeError):
    """A block-accounting invariant was violated (leak, double free,
    foreign id, stale table mirror)."""


# eq=False: live requests are identity objects (sampling branches share
# uid AND prompt, so a field-wise == would compare ndarrays)
@dataclasses.dataclass(eq=False)
class Request:
    uid: int
    prompt: np.ndarray               # (T,) int32
    max_new_tokens: int = 32
    # admission priority: HIGHER is served first; FIFO among equals
    priority: int = 0
    # per-request sampling seed (temperature > 0); None derives it from uid
    seed: Optional[int] = None
    # parallel sampling: n completions; branch i samples with seed base+i
    n: int = 1
    # --- SLOs (all times share the caller's clock, see step(now=...)) ---
    deadline: Optional[float] = None
    timeout: Optional[float] = None
    # filled by the scheduler
    output: Optional[np.ndarray] = None
    outputs: Optional[List[np.ndarray]] = None
    # queued -> running -> done | cancelled | expired | timeout | shed
    status: str = "queued"
    submit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # internal: host copy-out of a swap-preempted row (swap-resume)
    swapped: Optional["SwappedState"] = None
    # internal: tokens generated before a preemption (recompute-resume)
    resume_generated: Optional[List[int]] = None
    # internal: submission sequence number (admission tie-break)
    arrival: Optional[int] = None
    # internal: parallel-sampling bookkeeping of an expanded branch
    group: Optional["_SampleGroup"] = None
    branch: int = 0


@dataclasses.dataclass(eq=False)
class _SampleGroup:
    """One ``Request(n=k)`` group: the leader prefills the prompt, then
    the siblings attach to a snapshot of its prompt blocks (``shared``)
    and diverge by copy-on-write. ``unshared`` are the branches still
    owed a turn at the snapshot; ``results`` collects terminal branches."""
    parent: Request
    n: int
    prompt_len: int
    leader: int = 0
    ready: bool = False
    shared: List[int] = dataclasses.field(default_factory=list)
    unshared: set = dataclasses.field(default_factory=set)
    branches: List[Request] = dataclasses.field(default_factory=list)
    results: Dict[int, Request] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PrefillState:
    """Chunked-prefill cursor: ``feed`` (prompt, plus all but the last
    previously generated token on a recompute-resume) streams through the
    model ``done`` tokens at a time; ``resume`` restores the generated
    tokens when the prefill completes."""
    feed: np.ndarray                 # (T,) int32
    done: int = 0
    resume: Optional[List[int]] = None

    @property
    def remaining(self) -> int:
        return len(self.feed) - self.done


@dataclasses.dataclass
class SwappedState:
    """Host copy-out of a swap-preempted row: ``pool`` maps each pool
    leaf's path (layer entry index, leaf name) to the victim's blocks in
    table order, ``row`` each batch-led leaf's path (ring K/V and
    position ids, recurrent h/conv/cell) to the victim's row. The device
    blocks are freed at swap-out; swap-in restores both bit-exactly, the
    blocks into freshly allocated ones."""
    pool: Dict[Tuple, torch.Tensor]
    row: Dict[Tuple, torch.Tensor]
    n_blocks: int
    pos: int
    generated: List[int]
    prefill: Optional[PrefillState]
    key: Optional[int]
    nbytes: int
    attempts: int = 0        # failed swap-in tries (bounded retry)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                     # next cache position (= tokens written)
    generated: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    order: int = 0                   # admission sequence number
    key: Optional[int] = None        # request sampling seed
    prefill: Optional[PrefillState] = None   # None once fully prefilled


class BlockAllocator:
    """Host-side REFCOUNTED free list over the global KV block pool.
    ``alloc`` hands out blocks at refcount 1, ``acquire`` adds an owner to
    a live block, ``release`` drops one; a block returns to the free list
    when its last owner lets go. Over-release and foreign ids raise."""

    def __init__(self, num_blocks: int) -> None:
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self._refs = [0] * num_blocks

    @property
    def available(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        self._check(block)
        return self._refs[block]

    def _check(self, b: int) -> None:
        if not 0 <= b < self.num_blocks:
            raise AllocatorAuditError(f"foreign block id {b} "
                                      f"(pool has {self.num_blocks})")

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks at refcount 1, or None if not enough are free."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refs[b] = 1
        return got

    def acquire(self, blocks: List[int]) -> None:
        for b in blocks:
            self._check(b)
            if self._refs[b] == 0:
                raise AllocatorAuditError(
                    f"acquire of free block {b} (no existing owner)")
            self._refs[b] += 1

    def release(self, blocks: List[int]) -> None:
        for b in blocks:
            self._check(b)
            if self._refs[b] == 0:
                raise AllocatorAuditError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)

    free = release

    def free_list(self) -> List[int]:
        return list(self._free)


def _bucket(n: int) -> int:
    """Round up to a power of two (the shapes a later CUDA-graph capture
    keys on)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pool_leaves(cache):
    """(path, leaf, block axis) of every pool leaf: K/V pools and int8
    scale vectors. Scanned caches stack groups in front: (G, NB, ...)."""
    for e, entry in enumerate(paged_entries(cache)):
        ax = 1 if entry["block_table"].ndim == 3 else 0
        for name in _POOL_LEAVES:
            if name in entry:
                yield (e, name), entry[name], ax


def _calibration_batches(cfg: ModelConfig, t: int, n: int, device
                         ) -> List[Dict[str, torch.Tensor]]:
    """``n`` synthetic calibration batches of (2, t) uniform token ids,
    the reference's: batch i is ``randint(fold_in(PRNGKey(0), i), (2, t),
    0, vocab)`` over threefry (``repro_torch.random``), drawn on the CPU."""
    key = PRNGKey(0)
    return [{"tokens": randint(fold_in(key, i), (2, t), 0, cfg.vocab_size
                               ).long().to(device)}
            for i in range(n)]


def _calibrate_engine(params, cfg: ModelConfig, qconfig: QConfig,
                      max_len: int, num_batches: int, device) -> QuantContext:
    """PTQ-calibrate the activation ranges of the W8A8 tick, once, at
    engine construction: synthetic batches through the fp forward in
    'collect' mode, then the context flips to 'int8', where every range
    is a python float."""
    t = max(1, min(32, max_len, cfg.max_seq_len))
    batches = _calibration_batches(cfg, t, num_batches, device)

    def apply_fn(p, batch, ctx):
        return model_apply(p, cfg, batch, ctx=ctx)[0]

    ctx = calibrate(apply_fn, params, batches, qconfig, num_batches=num_batches)
    ctx.use_int8_runtime()
    return ctx


class ContinuousBatcher:
    """Token-budget slot-pool scheduler over a paged or a dense KV cache:
    one fused forward per tick advances every runnable row — decode rows
    by one token (or a verified draft run), prefilling rows by a chunk."""

    def __init__(self, params, cfg: ModelConfig, batch_size: int,
                 max_len: int, eos_id: Optional[int] = None,
                 paged: bool = True, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 gen: Optional[GenerateConfig] = None,
                 token_budget: int = 256,
                 prefill_chunk: Optional[int] = None,
                 admit_watermark: int = 0,
                 qconfig: Optional[QConfig] = None,
                 kv_int8: Optional[bool] = None,
                 calib_batches: int = 4,
                 prefill_budget: Optional[int] = None,
                 swap_break_even_tokens: Optional[int] = None,
                 swap_pool_bytes: Optional[int] = None,
                 swap_retry_limit: int = 3,
                 shed_infeasible: bool = True,
                 fault_shed_after: int = 8,
                 on_pool_exhausted: str = "raise",
                 prefix_cache: bool = False,
                 spec: Optional[SpecConfig] = None,
                 debug_audit: bool = False,
                 device="cuda") -> None:
        check_supported(cfg)
        if cfg.input_kind == "embeds":
            raise ValueError(
                "ContinuousBatcher serves token prompts, and a config of "
                "input_kind 'embeds' has no token path (an encoder over "
                "precomputed embeddings: run it through model_apply)")
        kinds = cfg.pattern + cfg.tail_pattern
        self.device = resolve_device(device)
        if kv_int8 is None:
            kv_int8 = qconfig is not None and paged
        if kv_int8 and not paged:
            raise ValueError(
                "kv_int8 requires paged=True: the int8 KV layout is the "
                "block pool + per-slot scale vectors (init_paged_cache)")
        self.kv_int8 = bool(kv_int8)
        self.qconfig = qconfig
        self._qctx = NO_QUANT
        if qconfig is not None:
            # per-layer int8 weight slices: the unrolled layer path (the
            # stacked params are tree_slice'd per group by model_apply)
            if cfg.scan_layers:
                cfg = dataclasses.replace(cfg, scan_layers=False)
            self._qctx = _calibrate_engine(params, cfg, qconfig, max_len,
                                           calib_batches, self.device)
            params = attach_int8_weights(params, skip=qconfig.skip_patterns)
        self.params = params
        self.cfg = cfg
        self.B = batch_size
        self.L = max_len
        self._gen = gen if gen is not None else GenerateConfig()
        self.eos_id = eos_id if eos_id is not None else self._gen.eos_id
        self.paged = paged
        if token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.token_budget = token_budget
        self.admit_watermark = admit_watermark
        self.slots = [_Slot() for _ in range(batch_size)]
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.failed: List[Request] = []
        self._order = 0
        self._arrival = 0
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1 (or None)")
        self.prefill_budget = prefill_budget
        self.swap_break_even_tokens = swap_break_even_tokens
        self.swap_pool_bytes = swap_pool_bytes
        self.swap_retry_limit = swap_retry_limit
        self.shed_infeasible = shed_infeasible
        self.fault_shed_after = fault_shed_after
        if on_pool_exhausted not in ("raise", "shed"):
            raise ValueError("on_pool_exhausted must be 'raise' or 'shed'")
        self.on_pool_exhausted = on_pool_exhausted
        self.debug_audit = debug_audit
        self.now = 0.0
        self._tick_ewma: Optional[float] = None
        self._prev_advanced = False
        self._alloc_fault = False
        self._fault_streak = 0
        self._swap_bytes = 0
        # FED tokens of the last step() (drafts included) vs tokens BANKED
        # into outputs; the counts vector of the last sub-step
        self.last_tick_tokens = 0
        self.last_tick_new_tokens = 0
        self.last_counts: Optional[np.ndarray] = None
        # forward calls made (one model_apply per sub-step)
        self.forward_calls = 0
        if paged:
            self.block_size = block_size
            n_entries = -(-max_len // block_size)
            self.num_blocks = num_blocks if num_blocks is not None \
                else batch_size * n_entries
            self.allocator = BlockAllocator(self.num_blocks)
            self.tables = np.full((batch_size, n_entries), -1, np.int32)
            self._tables_dirty = True
            self.cache = init_paged_cache(cfg, batch_size, max_len, self.num_blocks,
                                          block_size, kv_int8=self.kv_int8,
                                          device=self.device)
            # a 1-block pool: the template's pool leaves are never read
            template = init_paged_cache(cfg, 1, max_len, 1, block_size,
                                        kv_int8=self.kv_int8, device=self.device)
        else:
            self.cache = init_cache(cfg, batch_size, max_len, device=self.device)
            template = init_cache(cfg, 1, max_len, device=self.device)
        # a fresh batch-1 state: admission resets the slot's batch-led rows
        # (dense and ring K/V, ring pos_ids, recurrent h/conv/cell) from it, so
        # the previous occupant cannot leak into the new request
        self._row_template = {path: leaf for path, leaf, _ in row_leaves(template)}
        # recurrent states have no per-token write index to mask, so ragged
        # steps are not expressible: split decode / uniform prefill ticks
        self._uniform = any(k in _RECURRENT_KINDS for k in kinds)
        # sharing rides on the paged attn pools only: ring and recurrent
        # layers keep per-row state a shared block cannot carry
        self._can_share = paged and all(k == "attn" for k in kinds)
        # speculation is sound for global-attn KV, dense or paged: a
        # rejected draft's write is causally hidden, then overwritten
        if spec is not None and not all(k == "attn" for k in kinds):
            raise ValueError(
                "spec=SpecConfig(...) requires an all-'attn' layer "
                "pattern: rejected draft writes are only causally "
                "hidden in a global-attn KV cache — a local_attn "
                "ring write clobbers in-window history and "
                "recurrent states have no per-token write to mask")
        if prefix_cache and not self._can_share:
            raise ValueError(
                "prefix_cache=True requires paged=True and an "
                "all-'attn' layer pattern: ring/recurrent layers keep "
                "per-row state a shared block cannot carry")
        self.spec = spec
        self._drafter = NGramDrafter(spec) if spec is not None else None
        self._tick_drafts: Dict[int, List[int]] = {}
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.prefix_cache: Optional[PrefixCache] = \
            PrefixCache(block_size, self.allocator) if prefix_cache else None
        self._groups: List[_SampleGroup] = []
        self.cow_copies = 0
        self.shared_admissions = 0
        self.shared_tokens = 0
        # a prefill chunk on a local_attn layer must fit the ring, and its
        # own writes must not collide inside it
        ring_cap = min(max_len, cfg.window) \
            if (any(k == "local_attn" for k in kinds) and cfg.window) \
            else token_budget
        self._chunk_cap = min(prefill_chunk or token_budget, token_budget, ring_cap)
        make_step = make_mixed_step if spec is None else make_spec_step
        self._step_fn = make_step(cfg, self._gen, self._qctx)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request, rejecting impossible ones up front."""
        t = len(req.prompt)
        if t == 0:
            raise ValueError(
                f"request uid={req.uid}: empty prompt (there is no logits "
                f"position to sample a first token from)")
        if t > self.L - 1:
            raise ValueError(
                f"request uid={req.uid}: {t} prompt tokens do not fit a "
                f"max_len={self.L} {'row' if self.paged else 'slot'} (>= 1 "
                f"position must remain for decode)")
        if self.paged and self._blocks_for(t + 1) > self.num_blocks:
            raise ValueError(
                f"request uid={req.uid} needs {self._blocks_for(t + 1)} "
                f"blocks; the pool only has {self.num_blocks}")
        if req.n < 1:
            raise ValueError(f"request uid={req.uid}: n must be >= 1")
        if req.n > 1 and req.group is None:
            self._submit_group(req)
            return
        if req.arrival is None:
            req.arrival = self._arrival
            self._arrival += 1
        if req.submit_time is None:
            req.submit_time = self.now
        req.status = "queued"
        self.queue.append(req)

    def _submit_group(self, req: Request) -> None:
        """Expand ``Request(n=k)`` into k branches sharing the parent's
        uid; branch i samples with seed ``base + i``."""
        g = _SampleGroup(parent=req, n=req.n, prompt_len=len(req.prompt),
                         unshared=set(range(1, req.n)))
        base = req.seed if req.seed is not None else req.uid
        req.status = "queued"
        if req.submit_time is None:
            req.submit_time = self.now
        self._groups.append(g)
        for i in range(req.n):
            br = Request(uid=req.uid,
                         prompt=np.asarray(req.prompt, np.int32).copy(),
                         max_new_tokens=req.max_new_tokens,
                         priority=req.priority, seed=base + i,
                         deadline=req.deadline, timeout=req.timeout,
                         group=g, branch=i)
            g.branches.append(br)
            self.submit(br)

    def cancel(self, uid: int, status: str = "cancelled") -> bool:
        """Cancel a request by uid — queued, mid-prefill or decoding — the
        same tick, releasing its blocks. Returns False if it is not live."""
        hit = False
        while True:
            found = False
            for j, req in enumerate(self.queue):
                if req.uid == uid:
                    self.queue.pop(j)
                    self._fail(req, status)
                    hit = found = True
                    break
            if found:
                continue
            for i, s in enumerate(self.slots):
                if s.req is not None and s.req.uid == uid:
                    self._evict(i, status)
                    hit = found = True
                    break
            if not found:
                return hit

    def _fail(self, req: Request, status: str,
              output: Optional[List[int]] = None) -> None:
        if req.swapped is not None:
            self._swap_bytes -= req.swapped.nbytes
            if output is None and req.swapped.generated:
                output = req.swapped.generated
            req.swapped = None
        if output is None and req.resume_generated:
            output = req.resume_generated
        req.output = np.asarray(output if output is not None else [], np.int32)
        req.status = status
        req.finish_time = self.now
        self._land(req)

    def _land(self, req: Request) -> None:
        """Route a terminal request to done/failed; sampling branches fold
        into their parent when the group's last branch lands."""
        g = req.group
        if g is None:
            (self.done if req.status == "done" else self.failed).append(req)
            return
        g.results[req.branch] = req
        if not g.ready and req.branch == g.leader:
            live = sorted(br.branch for br in g.branches
                          if br.branch not in g.results)
            if live:
                g.leader = live[0]
        if req.branch in g.unshared:
            g.unshared.discard(req.branch)
            self._maybe_drop_share(g)
        if len(g.results) == g.n:
            self._finalize_group(g)

    def _maybe_drop_share(self, g: _SampleGroup) -> None:
        if g.shared and not g.unshared:
            self.allocator.release(g.shared)
            g.shared = []

    def _finalize_group(self, g: _SampleGroup) -> None:
        if g.shared:
            self.allocator.release(g.shared)
            g.shared = []
        if g in self._groups:
            self._groups.remove(g)
        p = g.parent
        branches = [g.results[i] for i in range(g.n)]
        p.outputs = [br.output for br in branches]
        p.output = p.outputs[0]
        bad = [br.status for br in branches if br.status != "done"]
        p.status = "done" if not bad else bad[0]
        fts = [br.first_token_time for br in branches
               if br.first_token_time is not None]
        p.first_token_time = min(fts) if fts else None
        p.finish_time = self.now
        (self.done if p.status == "done" else self.failed).append(p)

    def _evict(self, i: int, status: str) -> None:
        s = self.slots[i]
        out = (s.prefill.resume if s.prefill is not None and s.prefill.resume
               else s.generated)
        self._release_blocks(i)
        self._fail(s.req, status, output=list(out))
        self.slots[i] = _Slot()

    def _release_blocks(self, i: int) -> None:
        """The ONE path blocks travel back to the allocator (nothing to do
        in dense mode)."""
        s = self.slots[i]
        if not self.paged:
            return
        if s.blocks:
            self.allocator.release(s.blocks)
            s.blocks = []
        self.tables[i] = -1
        self._tables_dirty = True

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.req is None]

    def _blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def _admit_key(self, j: int):
        r = self.queue[j]
        d = r.deadline if r.deadline is not None else float("inf")
        return (-r.priority, d, r.arrival)

    def _admit(self) -> None:
        """Bind queued requests to free slots in ``_admit_key`` order while
        (paged) the free-block watermark allows; a swapped request is
        restored (all or nothing) or deferred for the tick."""
        deferred: set = set()
        for i in self._free_slots():
            while True:
                cands = [j for j, r in enumerate(self.queue)
                         if id(r) not in deferred and self._admissible(r)]
                if not cands:
                    return
                if self.paged and self._avail() < self.admit_watermark:
                    return
                j = min(cands, key=self._admit_key)
                req = self.queue[j]
                if req.swapped is not None:
                    ok = self._try_swap_in(i, j)
                    if ok is None:       # degraded to recompute: re-pick
                        continue
                    if not ok:           # denied this tick: try next cand
                        deferred.add(id(req))
                        continue
                    break
                self.queue.pop(j)
                self._bind_slot(i, req)
                break

    def _admissible(self, r: Request) -> bool:
        """Sampling siblings wait for their leader's prefill on engines
        that can share; elsewhere the branches are independent requests."""
        g = r.group
        if g is None or not self._can_share:
            return True
        return g.ready or r.branch == g.leader

    def _reset_row(self, i: int) -> None:
        """Reset slot ``i``'s batch-led rows (dense and ring K/V, ring
        pos_ids, recurrent h/conv/cell) to the fresh template; pool leaves are
        shared and left alone (new blocks are written before any causally
        reachable read)."""
        for path, leaf, ax in row_leaves(self.cache):
            src = self._row_template[path]
            leaf[(slice(None),) * ax + (i,)] = src[(slice(None),) * ax + (0,)]

    def _bind_slot(self, i: int, req: Request) -> None:
        """Fresh (or recompute-resume) admission into slot ``i``."""
        resume = req.resume_generated
        req.resume_generated = None
        if resume:
            feed = np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(resume[:-1], np.int32)])
        else:
            feed = np.asarray(req.prompt, np.int32)
        self._reset_row(i)
        key = int(req.seed if req.seed is not None else req.uid)
        self.slots[i] = _Slot(
            req=req, pos=0, generated=[], blocks=[], order=self._order,
            key=key,
            prefill=PrefillState(feed=feed,
                                 resume=list(resume) if resume else None))
        self._order += 1
        req.status = "running"
        if self.paged:
            self._attach_prefix(i, resumed=bool(resume))

    def _attach_prefix(self, i: int, resumed: bool) -> None:
        """Map the longest shareable prefix of slot ``i``'s feed onto
        EXISTING blocks (sampling-group snapshot, else the prefix trie),
        acquiring one reference each, and skip its prefill."""
        s = self.slots[i]
        req = s.req
        g = req.group
        blocks: List[int] = []
        start = 0
        if (self._can_share and g is not None and not resumed
                and req.branch in g.unshared and g.shared):
            blocks = list(g.shared)
            start = g.prompt_len - 1
            self.allocator.acquire(blocks)
            g.unshared.discard(req.branch)
            self._maybe_drop_share(g)
        elif self.prefix_cache is not None:
            blocks = self.prefix_cache.match(s.prefill.feed)
            start = len(blocks) * self.block_size
            if blocks:
                self.allocator.acquire(blocks)
        if not blocks or start <= 0:
            if blocks and start <= 0:    # 1-token prompt: nothing to skip
                self.allocator.release(blocks)
            return
        s.blocks = list(blocks)
        self.tables[i, :len(blocks)] = blocks
        self._tables_dirty = True
        s.pos = start
        s.prefill.done = start
        self.shared_admissions += 1
        self.shared_tokens += start

    # ---- swapped preemption ------------------------------------------
    def _swap_eligible(self, s: _Slot) -> bool:
        """Swap when the cached context is at least the break-even token
        count (copy cost is linear in KV bytes, recompute a full forward
        per token) and the host swap pool has room."""
        if self.swap_break_even_tokens is None or not self.paged:
            return False
        if s.pos < self.swap_break_even_tokens:
            return False
        if self.swap_pool_bytes is not None and \
                self._swap_bytes >= self.swap_pool_bytes:
            return False
        return True

    def _swap_out(self, i: int) -> SwappedState:
        """Copy slot ``i``'s pool blocks (K/V and int8 scales together) to
        host memory in table order, and its row of every batch-led leaf;
        the caller releases the blocks."""
        s = self.slots[i]
        idx = torch.as_tensor(s.blocks, dtype=torch.long, device=self.device)
        pool = {path: leaf.index_select(ax, idx).cpu()
                for path, leaf, ax in _pool_leaves(self.cache)}
        row = {path: leaf.select(ax, i).cpu()
               for path, leaf, ax in row_leaves(self.cache)}
        st = s.prefill
        return SwappedState(
            pool=pool, row=row, n_blocks=len(s.blocks), pos=s.pos,
            generated=list(s.generated),
            prefill=None if st is None else PrefillState(
                feed=st.feed, done=st.done,
                resume=list(st.resume) if st.resume else None),
            key=s.key,
            nbytes=sum(a.numel() * a.element_size()
                       for a in (*pool.values(), *row.values())))

    def _try_swap_in(self, i: int, j: int) -> Optional[bool]:
        """Restore queued request ``j`` into slot ``i``: True on success,
        False when the pool cannot hand out its blocks this tick, None
        when it degraded to recompute."""
        req = self.queue[j]
        sw = req.swapped
        blocks = self._alloc(sw.n_blocks)
        if blocks is None:
            sw.attempts += 1
            if sw.attempts > self.swap_retry_limit:
                self._drop_swap(req)
                return None
            return False
        self.queue.pop(j)
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for path, leaf, ax in _pool_leaves(self.cache):
            leaf.index_copy_(ax, idx, sw.pool[path].to(self.device))
        for path, leaf, ax in row_leaves(self.cache):
            leaf.select(ax, i).copy_(sw.row[path])
        self.tables[i, :len(blocks)] = blocks
        self.tables[i, len(blocks):] = -1
        self._tables_dirty = True
        self.slots[i] = _Slot(req=req, pos=sw.pos, generated=list(sw.generated),
                              blocks=list(blocks), order=self._order,
                              key=sw.key, prefill=sw.prefill)
        self._order += 1
        self._swap_bytes -= sw.nbytes
        req.swapped = None
        req.status = "running"
        return True

    def _drop_swap(self, req: Request) -> None:
        """Degrade a swapped request to recompute-resume."""
        sw = req.swapped
        req.swapped = None
        self._swap_bytes -= sw.nbytes
        if sw.prefill is not None and sw.prefill.resume:
            req.resume_generated = list(sw.prefill.resume)
        elif sw.generated:
            req.resume_generated = list(sw.generated)

    def _preempt(self, i: int) -> None:
        """Evict slot ``i`` on pool pressure and re-queue it (keeping its
        arrival rank): swap out past the break-even, else stash the
        generated tokens for recompute-resume."""
        s = self.slots[i]
        req = s.req
        if self._swap_eligible(s):
            req.swapped = self._swap_out(i)
            self._swap_bytes += req.swapped.nbytes
            req.resume_generated = None
        elif s.prefill is not None and s.prefill.resume:
            req.resume_generated = list(s.prefill.resume)
        else:
            req.resume_generated = list(s.generated)
        self._release_blocks(i)
        req.status = "queued"
        self.queue.append(req)
        self.slots[i] = _Slot()

    def preempt_slot(self, i: int) -> None:
        """Force-preempt live slot ``i`` (tests): the pool-pressure path."""
        if self.slots[i].req is None:
            raise ValueError(f"slot {i} is not occupied")
        self._preempt(i)

    # ------------------------------------------------------------------
    def _avail(self) -> int:
        """Blocks an allocation could obtain: free list plus what LRU trie
        eviction could release."""
        n = self.allocator.available
        if self.prefix_cache is not None:
            n += self.prefix_cache.evictable()
        return n

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Allocate, evicting trie blocks only on a genuine shortage."""
        if n <= 0:
            return []
        if self.prefix_cache is not None and self.allocator.available < n:
            self.prefix_cache.evict(n - self.allocator.available)
        return self.allocator.alloc(n)

    def _copy_blocks(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy-on-write block copies on the device, before this tick's
        forward writes anything."""
        self.cow_copies += len(pairs)
        src = torch.as_tensor([p[0] for p in pairs], dtype=torch.long,
                              device=self.device)
        dst = torch.as_tensor([p[1] for p in pairs], dtype=torch.long,
                              device=self.device)
        copy_pool_blocks(self.cache, src, dst)

    def _grow_blocks(self, i: int, n_tokens: int) -> int:
        """Grow slot ``i``'s blocks to cover its next ``n_tokens`` writes
        as far as the pool allows (copy-on-write first if the block under
        the cursor is shared). Returns how many writes are covered."""
        s = self.slots[i]
        e = s.pos // self.block_size
        if e < len(s.blocks) and self.allocator.refcount(s.blocks[e]) > 1:
            got = self._alloc(1)
            if got is None:
                if self.allocator.available >= 1:
                    self._alloc_fault = True
                return 0
            old, new = s.blocks[e], got[0]
            self._copy_blocks([(old, new)])
            self.allocator.release([old])
            s.blocks[e] = new
            self.tables[i, e] = new
            self._tables_dirty = True
        need = self._blocks_for(s.pos + n_tokens) - len(s.blocks)
        if need > 0:
            take = min(need, self._avail())
            got = self._alloc(take) if take > 0 else None
            if take > 0 and got is None:
                # denied despite availability: a transient fault, not
                # pressure — _plan stalls instead of preempting
                self._alloc_fault = True
            if got:
                self.tables[i, len(s.blocks):len(s.blocks) + len(got)] = got
                s.blocks.extend(got)
                self._tables_dirty = True
        return max(0, min(n_tokens, len(s.blocks) * self.block_size - s.pos))

    def _plan(self, want_decode: bool = True, want_prefill: bool = True,
              allow_preempt: bool = True) -> np.ndarray:
        """Carve this sub-step's per-row token counts against the budget:
        decode rows first (1 + drafts), then prefill chunks (earliest
        deadline first, then admission order) within the prefill budget.
        On a recurrent config every prefilling row takes the same chunk
        (the shortest remaining prompt, capped), and a row whose blocks
        cannot grow to it sits the sub-step out. If the pool is exhausted
        and NO row can advance, preempt the most recently admitted stalled
        row and retry (a transient allocator fault stalls the tick
        instead; a lone row that outgrows the whole pool raises or is
        shed)."""
        while True:
            counts = np.zeros(self.B, np.int32)
            stalled: List[int] = []
            budget = self.token_budget
            pleft = self.prefill_budget if self.prefill_budget is not None \
                else self.token_budget
            self._tick_drafts = {}
            for i, s in enumerate(self.slots):
                if not want_decode or s.req is None or s.prefill is not None:
                    continue
                drafts: List[int] = []
                if self.spec is not None:
                    k_cap = min(self.spec.k, self.L - 2 - s.pos,
                                s.req.max_new_tokens - len(s.generated) - 1,
                                budget - 1)
                    if k_cap > 0:
                        drafts = self._drafter.propose(s.req.prompt,
                                                       s.generated, k_cap)
                c = 1 + len(drafts)
                if self.paged:
                    # a short grant truncates the drafts instead of stalling
                    c = self._grow_blocks(i, c)
                    if c < 1:
                        stalled.append(i)
                        continue
                    drafts = drafts[:c - 1]
                counts[i] = c
                budget -= c
                if drafts:
                    self._tick_drafts[i] = drafts

            def edf(i):
                s = self.slots[i]
                d = s.req.deadline if s.req.deadline is not None else float("inf")
                return (d, s.order)
            pre = sorted((i for i, s in enumerate(self.slots)
                          if s.req is not None and s.prefill is not None),
                         key=edf) if want_prefill else []
            uniform_c = None
            if self._uniform and pre:
                uniform_c = min(min(self.slots[i].prefill.remaining for i in pre),
                                self._chunk_cap, max(budget, 0), max(pleft, 0))
            for i in pre:
                if budget <= 0 or pleft <= 0:
                    break
                s = self.slots[i]
                if uniform_c is not None:
                    if uniform_c > min(budget, pleft):
                        break
                    c = uniform_c
                else:
                    c = min(s.prefill.remaining, self._chunk_cap, budget, pleft)
                if c > 0 and self.paged:
                    c = self._grow_blocks(i, c)
                    if uniform_c is not None and 0 < c < uniform_c:
                        # a short chunk would make the step ragged; the
                        # recurrent row sits this sub-step out instead
                        c = 0
                if c <= 0:
                    stalled.append(i)
                    continue
                counts[i] = c
                budget -= c
                pleft -= c
            if counts.any() or not stalled or not allow_preempt or self._alloc_fault:
                return counts
            if sum(s.req is not None for s in self.slots) == 1:
                if self._drop_group_shares():
                    continue
                s = self.slots[stalled[0]]
                if self.on_pool_exhausted == "shed":
                    self._evict(stalled[0], "shed")
                    continue
                raise RuntimeError(
                    f"block pool too small: request uid={s.req.uid} holds "
                    f"{len(s.blocks)}/{self.num_blocks} blocks and still "
                    f"needs more; increase num_blocks")
            self._preempt(max(stalled, key=lambda i: self.slots[i].order))

    def _drop_group_shares(self) -> bool:
        """Last-resort pool relief: release every sampling snapshot."""
        hit = False
        for g in self._groups:
            if g.shared:
                self.allocator.release(g.shared)
                g.shared = []
                g.unshared.clear()
                hit = True
        return hit

    def _live_width(self) -> Optional[int]:
        """The tick's block-table read width: the most blocks any occupied
        slot holds, rounded up to a power of two. Allocation is
        prefix-dense, so slicing the read there is exact. None in dense
        mode."""
        if not self.paged:
            return None
        held = max((len(s.blocks) for s in self.slots if s.req is not None),
                   default=1)
        return min(_bucket(held), self.tables.shape[1])

    def _retire(self) -> None:
        for i, s in enumerate(self.slots):
            if s.req is None or s.prefill is not None:
                continue
            hit_eos = self.eos_id is not None and s.generated and \
                s.generated[-1] == self.eos_id
            if len(s.generated) >= s.req.max_new_tokens or hit_eos or \
                    s.pos >= self.L - 1:
                s.req.output = np.asarray(s.generated, np.int32)
                s.req.status = "done"
                s.req.finish_time = self.now
                self._release_blocks(i)
                self._land(s.req)
                self.slots[i] = _Slot()

    def _set_tables(self) -> None:
        """Mirror the host tables into every layer's ``block_table``: one
        device tensor shared by all layers (a stride-0 view over a
        scanned cache's group axis)."""
        table = torch.tensor(self.tables, device=self.device)
        for entry in paged_entries(self.cache):
            old = entry["block_table"]
            entry["block_table"] = table.expand(old.shape) \
                if old.ndim == 3 else table
        self._tables_dirty = False

    def _substep(self, want_decode: bool = True, want_prefill: bool = True,
                 allow_preempt: bool = True) -> int:
        """Plan, assemble and run ONE fused forward; apply its results to
        the slots. Returns the number of rows that advanced."""
        counts = self._plan(want_decode, want_prefill, allow_preempt)
        run = np.flatnonzero(counts)
        if run.size == 0:
            return 0
        self.last_counts = counts.copy()
        # recurrent rows would feed a padding tail into their recurrence
        # (no per-token write index to mask): uniform steps run at the
        # exact chunk length
        # repro: ignore[R002] uniform recurrent rows need the exact chunk length
        t_step = int(counts.max()) if self._uniform else _bucket(int(counts.max()))
        tokens = np.zeros((self.B, t_step), np.int64)
        pos = np.zeros((self.B,), np.int64)
        final = {}
        for i in run:
            s = self.slots[i]
            c = int(counts[i])
            pos[i] = s.pos
            if s.prefill is None:
                tokens[i, 0] = s.generated[-1] if s.generated else 0
                drafts = self._tick_drafts.get(i)
                if drafts:
                    tokens[i, 1:c] = drafts
            else:
                st = s.prefill
                tokens[i, :c] = st.feed[st.done:st.done + c]
                final[i] = st.done + c == len(st.feed)
        keys = np.asarray([s.key if s.key is not None else 0
                           for s in self.slots], np.int64)
        dev = self.device
        live_widths = None
        if self.paged:
            if self._tables_dirty:
                self._set_tables()
            live_widths = torch.as_tensor([len(s.blocks) for s in self.slots],
                                          dtype=torch.int32, device=dev)
        with torch.no_grad():
            nxt, self.cache = self._step_fn(
                self.params, self.cache, torch.as_tensor(tokens, device=dev),
                torch.as_tensor(pos, device=dev),
                torch.as_tensor(counts, dtype=torch.int64, device=dev),
                torch.as_tensor(keys, device=dev), self._live_width(),
                live_widths)
        self.forward_calls += 1
        nt = nxt.cpu().numpy()
        spec_on = self.spec is not None
        self.last_tick_tokens += int(counts.sum())
        for i in run:
            s = self.slots[i]
            c = int(counts[i])
            if s.prefill is None:
                if spec_on:
                    self._apply_spec_decode(i, nt[i], c)
                else:
                    s.generated.append(int(nt[i]))
                    s.pos += 1
                    self.last_tick_new_tokens += 1
            else:
                st = s.prefill
                st.done += c
                s.pos += c
                if final[i]:
                    # only the final chunk's last-token logits produce a
                    # token; a resumed request restores its continuation
                    first = int(nt[i, c - 1]) if spec_on else int(nt[i])
                    s.generated = list(st.resume) if st.resume else [first]
                    s.prefill = None
                    if not st.resume:
                        self.last_tick_new_tokens += 1
                    self._on_prefill_done(i)
            if s.generated and s.req.first_token_time is None:
                s.req.first_token_time = self.now
        return int(run.size)

    def _apply_spec_decode(self, i: int, tgt: np.ndarray, c: int) -> None:
        """Bank the longest draft prefix matching the target row plus the
        bonus token, truncated at EOS / max_new_tokens."""
        s = self.slots[i]
        drafts = self._tick_drafts.pop(i, [])
        n_acc = 0
        while n_acc < len(drafts) and drafts[n_acc] == int(tgt[n_acc]):
            n_acc += 1
        self.spec_drafted += len(drafts)
        self.spec_accepted += n_acc
        banked = drafts[:n_acc] + [int(tgt[n_acc])]
        room = s.req.max_new_tokens - len(s.generated)
        kept: List[int] = []
        for tok in banked:
            kept.append(tok)
            if self.eos_id is not None and tok == self.eos_id:
                break
            if len(kept) >= room:
                break
        s.generated.extend(kept)
        s.pos += len(kept)
        self.last_tick_new_tokens += len(kept)

    def _on_prefill_done(self, i: int) -> None:
        """Publish the row's full prompt blocks to the prefix trie; a
        sampling-group leader snapshots its prompt blocks for siblings."""
        s = self.slots[i]
        req = s.req
        plen = len(req.prompt)
        if self.prefix_cache is not None:
            n_full = plen // self.block_size
            if n_full > 0:
                prompt = np.asarray(req.prompt, np.int32)
                self.prefix_cache.insert(prompt[:n_full * self.block_size],
                                         s.blocks[:n_full])
        g = req.group
        if (g is not None and self._can_share and not g.ready
                and req.branch == g.leader):
            g.ready = True
            if g.unshared:
                shared = s.blocks[:self._blocks_for(plen)]
                self.allocator.acquire(shared)
                g.shared = list(shared)

    # ---- SLO enforcement / degradation -------------------------------
    def _min_ticks_left(self, req: Request) -> int:
        """Optimistic lower bound on ticks to finish a QUEUED request."""
        if req.swapped is not None:
            sw = req.swapped
            feed_left = sw.prefill.remaining if sw.prefill is not None else 0
            dec = max(0, req.max_new_tokens - len(sw.generated))
        else:
            resume = req.resume_generated or []
            feed_left = len(req.prompt) + max(0, len(resume) - 1)
            dec = max(0, req.max_new_tokens - len(resume))
        cap = min(self._chunk_cap, self.prefill_budget or self.token_budget)
        if self.spec is not None:
            dec = -(-dec // (self.spec.k + 1))
        return -(-feed_left // max(cap, 1)) + dec

    def _enforce_slos(self) -> None:
        now = self.now
        for req in list(self.queue):
            late = req.deadline is not None and now > req.deadline
            timed = req.timeout is not None and req.submit_time is not None \
                and now - req.submit_time > req.timeout
            if late or timed:
                self.queue.remove(req)
                self._fail(req, "expired" if late else "timeout")
            elif (self.shed_infeasible and req.deadline is not None
                  and self._tick_ewma is not None
                  and now + self._min_ticks_left(req) * self._tick_ewma
                  > req.deadline):
                self.queue.remove(req)
                self._fail(req, "shed")
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            req = s.req
            late = req.deadline is not None and now > req.deadline
            timed = req.timeout is not None and req.submit_time is not None \
                and now - req.submit_time > req.timeout
            if late or timed:
                self._evict(i, "expired" if late else "timeout")

    def _shed_one(self) -> None:
        """Persistent-fault degradation: drop ONE victim, lowest priority
        first, newest among equals, queued before running."""
        if self.queue:
            j = min(range(len(self.queue)),
                    key=lambda j: (self.queue[j].priority,
                                   -(self.queue[j].arrival or 0)))
            self._fail(self.queue.pop(j), "shed")
            return
        live = [i for i, s in enumerate(self.slots) if s.req is not None]
        if live:
            i = min(live, key=lambda i: (self.slots[i].req.priority,
                                         -self.slots[i].order))
            self._evict(i, "shed")

    def audit(self) -> None:
        """Every block's refcount equals its owner count across slot
        tables, the prefix trie and sampling snapshots; free blocks are
        exactly the zero-ref ones; host tables mirror slot state; swap
        bytes balance. Raises ``AllocatorAuditError`` otherwise. A dense
        engine holds no blocks: nothing to check."""
        if not self.paged:
            return
        owners: Dict[int, int] = {}
        for i, s in enumerate(self.slots):
            if s.req is None:
                if s.blocks:
                    raise AllocatorAuditError(
                        f"empty slot {i} holds blocks {s.blocks}")
                if not (self.tables[i] == -1).all():
                    raise AllocatorAuditError(
                        f"empty slot {i} has stale table entries")
                continue
            if len(set(s.blocks)) != len(s.blocks):
                raise AllocatorAuditError(f"slot {i} maps a block twice")
            for b in s.blocks:
                owners[b] = owners.get(b, 0) + 1
            w = len(s.blocks)
            if list(self.tables[i, :w]) != s.blocks or \
                    not (self.tables[i, w:] == -1).all():
                raise AllocatorAuditError(
                    f"slot {i} table row {self.tables[i].tolist()} does "
                    f"not mirror its blocks {s.blocks}")
        if self.prefix_cache is not None:
            cached = self.prefix_cache.cached_blocks()
            if len(cached) != len(set(cached)):
                raise AllocatorAuditError(
                    "prefix trie owns a block through two nodes")
            for b in cached:
                owners[b] = owners.get(b, 0) + 1
        for g in self._groups:
            for b in g.shared:
                owners[b] = owners.get(b, 0) + 1
        free = self.allocator.free_list()
        if len(free) != len(set(free)):
            raise AllocatorAuditError("free list repeats a block id")
        free_set = set(free)
        for b in range(self.num_blocks):
            rc = self.allocator.refcount(b)
            if rc != owners.get(b, 0):
                raise AllocatorAuditError(
                    f"block {b}: refcount {rc} != owner count "
                    f"{owners.get(b, 0)} (slots + trie + sampling groups)")
            if (rc == 0) != (b in free_set):
                raise AllocatorAuditError(
                    f"block {b}: refcount {rc} inconsistent with free-"
                    f"list membership {b in free_set}")
        swap_bytes = sum(r.swapped.nbytes for r in self.queue
                         if r.swapped is not None)
        if swap_bytes != self._swap_bytes:
            raise AllocatorAuditError(
                f"swap byte accounting broken: held={self._swap_bytes} "
                f"but queued swaps sum to {swap_bytes}")

    def step(self, now: Optional[float] = None) -> int:
        """One tick: enforce SLOs, retire, admit, run the fused step (or
        the split decode / uniform prefill sub-steps of a recurrent
        config), retire again. ``now`` is the caller's clock (default: a tick
        counter). Returns the number of rows advanced."""
        now = self.now + 1.0 if now is None else float(now)
        dt = now - self.now
        if dt > 0 and self._prev_advanced:
            self._tick_ewma = dt if self._tick_ewma is None \
                else 0.8 * self._tick_ewma + 0.2 * dt
        self.now = now
        self._alloc_fault = False
        self.last_tick_tokens = 0
        self.last_tick_new_tokens = 0
        self._retire()
        self._enforce_slos()
        self._admit()
        if self._uniform:
            # recurrent configs: a decode sub-step, then a uniform prefill
            # sub-step; each may preempt only when the other cannot advance
            has_pre = any(s.req is not None and s.prefill is not None
                          for s in self.slots)
            n = self._substep(want_prefill=False, allow_preempt=not has_pre)
            if has_pre:
                n += self._substep(want_decode=False, allow_preempt=(n == 0))
        else:
            n = self._substep()
        self._retire()
        self._prev_advanced = n > 0
        if self._alloc_fault and n == 0:
            self._fault_streak += 1
            if self._fault_streak > self.fault_shed_after:
                self._shed_one()
        elif not self._alloc_fault:
            self._fault_streak = 0
        if self.debug_audit:
            self.audit()
        return n

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.queue or any(s.req for s in self.slots)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.done
