"""Prefix cache: a token-ids-keyed trie over refcounted KV pool blocks (a
copy of ``repro.serving.prefix_cache``, pure Python).

At fleet scale most prompts share a system prefix, so a per-request block
pool re-stores (and re-prefills) the same KV content thousands of times.
This module is the host-side half of prefix *sharing*: a trie whose edges
are tuples of ``block_size`` token ids and whose nodes each pin ONE
physical pool block holding exactly that block's KV content. Admission
walks the trie with the arriving feed (``PrefixCache.match``) and maps
the longest cached prefix straight onto the existing physical blocks —
the row acquires a reference per block, its block table points at them,
and chunked prefill starts after the shared span. Completion publishes
the row's full prompt blocks back (``insert``), deduplicating against
nodes that already exist.

Why this is correct, not just fast:

  * a physical block id is valid for EVERY layer's pool — the scheduler
    keeps ONE host block table broadcast into all layers — so one trie
    node per block suffices;
  * KV bits are a pure function of (token value, logical position): the
    engine's chunk-size/slot/preemption invariance is already bitwise,
    and int8 KV quantizes each token exactly once at write with a
    per-token scale slot (``quant.kv_cache``), so a block written by one
    request reads bit-identically for any other request whose feed
    starts with the same tokens;
  * only FULL prompt blocks are cached. A partial tail block would keep
    receiving its first owner's later writes, so its content is not a
    function of the key. Full blocks under a shared prefix are write-once
    — matched rows start writing strictly after the span, which is why
    the scheduler's copy-on-write only ever fires for sampling-group
    tail sharing, never for trie hits;
  * a match is capped so at least one feed token remains to prefill:
    the request's first sampled token needs the logits of its last
    prompt token, which only a forward over that token produces.

Ownership: the trie holds exactly one allocator reference per node
(acquired at insert, released at evict), so the scheduler audit's
invariant — every block's refcount equals its owner count across slot
tables + trie + sampling groups — extends naturally. Under pool pressure
the scheduler evicts LRU nodes whose block has no other owner
(``evict``); nodes whose block a live row still references are skipped
(evicting them would free nothing) and children are always evicted
before their parent, so the trie never dangles. The cache can therefore
delay an allocation by at most one eviction sweep — it never *blocks*
admission.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class _Node:
    """One cached block: ``key`` is the tuple of ``block_size`` token ids
    this block holds, ``block`` the physical pool id (one allocator ref),
    ``last_use`` an LRU clock stamped by every match/insert that touches
    the node."""

    __slots__ = ("key", "block", "children", "parent", "last_use")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["_Node"]) -> None:
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class PrefixCache:
    """Block-granular prefix trie over a refcounted ``BlockAllocator``.

    The allocator is shared with the scheduler; the trie participates in
    block ownership exactly like a slot row does (one ref per node).
    ``hits``/``misses``/``tokens_reused``/``evictions`` are cumulative
    counters for observability and benchmarks."""

    def __init__(self, block_size: int, allocator) -> None:
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self.allocator = allocator
        self._root = _Node(None, -1, None)
        self._clock = 0
        self._count = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0

    def __len__(self) -> int:
        return self._count

    # ------------------------------------------------------------------
    def match(self, tokens) -> List[int]:
        """Longest cached block-aligned prefix of ``tokens``, as physical
        block ids in order. Capped at ``(len(tokens) - 1) // block_size``
        blocks so >= 1 token always remains for the caller to prefill
        (the first sampled token needs the last feed token's logits).
        Touching a path refreshes its LRU stamps root-to-leaf. The caller
        must acquire its own references on the returned blocks before the
        next eviction can run."""
        bs = self.block_size
        max_blocks = max(0, (len(tokens) - 1) // bs)
        self._clock += 1
        node = self._root
        out: List[int] = []
        for j in range(max_blocks):
            key = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = self._clock
            out.append(child.block)
            node = child
        if out:
            self.hits += 1
            self.tokens_reused += len(out) * bs
        else:
            self.misses += 1
        return out

    def insert(self, tokens, blocks: List[int]) -> int:
        """Publish ``tokens``' full blocks into the trie, backed by the
        caller's physical ``blocks`` (parallel, block-aligned, block ``j``
        holding ``tokens[j*bs:(j+1)*bs]``). Existing nodes are kept — two
        concurrent cold prefills of the same prompt dedupe onto whichever
        published first; the loser's blocks simply stay private to its
        row. Each NEW node acquires one allocator reference. Returns the
        number of nodes added."""
        bs = self.block_size
        n_full = min(len(tokens) // bs, len(blocks))
        self._clock += 1
        node = self._root
        added = 0
        for j in range(n_full):
            key = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(blocks[j]), node)
                self.allocator.acquire([child.block])
                node.children[key] = child
                self._count += 1
                added += 1
            child.last_use = self._clock
            node = child
        return added

    # ------------------------------------------------------------------
    def _evictable_leaves(self) -> List[_Node]:
        """Leaves whose block the trie is the SOLE owner of (refcount 1):
        evicting anything else frees no memory, and evicting a non-leaf
        would dangle its children."""
        out: List[_Node] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            for ch in node.children.values():
                if ch.children:
                    stack.append(ch)
                elif self.allocator.refcount(ch.block) == 1:
                    out.append(ch)
        return out

    def evictable(self) -> int:
        """How many blocks eviction could free right now. Live ownership
        is prefix-closed (a row matching a path holds refs on the whole
        path), so every sole-owner node is reachable leaf-upward and the
        count is simply the number of refcount-1 nodes."""
        n = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            for ch in node.children.values():
                stack.append(ch)
                if self.allocator.refcount(ch.block) == 1:
                    n += 1
        return n

    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks, least-recently-used sole-owner leaves
        first (a parent becomes a leaf once its children are gone, so a
        cold chain drains tail-to-root). Returns how many were freed."""
        freed = 0
        while freed < n:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_use)
            del victim.parent.children[victim.key]
            self.allocator.release([victim.block])
            self._count -= 1
            self.evictions += 1
            freed += 1
        return freed

    def clear(self) -> int:
        """Evict everything evictable (tests, shutdown)."""
        return self.evict(self._count)

    # ------------------------------------------------------------------
    def cached_blocks(self) -> List[int]:
        """All block ids the trie currently owns (audit surface)."""
        out: List[int] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            for ch in node.children.values():
                out.append(ch.block)
                stack.append(ch)
        return out
