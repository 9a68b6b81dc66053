"""PrefixKVCache — paged cross-request KV reuse (DESIGN.md §2.4).

Facade over :class:`BlockPool` + :class:`PrefixIndex`:

  * ``lookup(tokens)``   — longest cached block-aligned prefix; pins every
    matched block so eviction can never free KV an execution is reading.
  * ``insert(tokens, payload_fn)`` — index the whole-block spans of a prompt
    that are not cached yet; ``payload_fn(start, end)`` materializes the KV
    for a new span (host transfer happens only for blocks actually admitted).
  * eviction — when the pool is exhausted, unpinned trie leaves are scored
    by ``value_fn`` (the pruning chapter's "not worth pursuing" economics
    applied to residency: expected time saved by a future hit, decayed by
    idle age) and the cheapest are recycled.  An insert gathers and scores
    its candidates once, at the first block the full pool lacks, and pops
    its victims from a heap (:meth:`PrefixKVCache._frontier`).

The payload is opaque: the serving engine stores host ``(k, v)`` arrays;
the discrete-event simulator stores nothing and uses the same admission/
eviction dynamics analytically.  No JAX imports here — this module must
stay importable by the pure-numpy simulation path.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

from .pool import Block, BlockPool
from .trie import PrefixIndex

__all__ = ["CacheHit", "CombinedPrefixIndex", "PrefixKVCache"]


@dataclass
class CacheHit:
    """A pinned view of the cached prefix for one prompt."""
    n_tokens: int                                 # cached-prefix length
    nodes: list = field(default_factory=list)     # TrieNodes, root-to-deepest

    @property
    def blocks(self) -> list[Block]:
        return [n.block for n in self.nodes]

    def __bool__(self) -> bool:
        return self.n_tokens > 0


def _default_value(block: Block, now: float) -> float:
    """Recency-and-frequency residency value used when no TimeEstimator is
    wired in: each past hit is evidence of future reuse; idle age decays it."""
    age = max(now - block.last_used, 1.0)
    return (1.0 + block.hits) / age


class PrefixKVCache:
    def __init__(self, n_blocks: int, block_size: int, value_fn=None,
                 clock_fn=None):
        self.pool = BlockPool(n_blocks, block_size)
        self.index = PrefixIndex(block_size)
        self._value_fn = value_fn           # (Block, now) -> float
        self._clock_fn = clock_fn or (lambda: 0.0)
        self.stats = {"lookups": 0, "hits": 0, "misses": 0, "inserts": 0,
                      "evictions": 0, "tokens_reused": 0, "rejected": 0,
                      "migrated_in": 0, "migrated_out": 0}
        #: optional repro.obs Telemetry recorder + attrs stamped on every
        #: event (owner sets e.g. {"plane": 0, "machine": 3}); pure
        #: recording — nothing here is read back by cache decisions
        self.tel = None
        self.tel_attrs: dict = {}

    @property
    def block_size(self) -> int:
        return self.pool.block_size

    # -- read path ------------------------------------------------------------
    def peek(self, tokens, max_tokens: int | None = None) -> int:
        """Cached-prefix length without pinning (admission-gate scoring)."""
        return self.index.match_len(tokens, max_tokens)

    def lookup(self, tokens, max_tokens: int | None = None) -> CacheHit:
        """Longest cached prefix, pinned.  ``max_tokens`` caps the match (the
        engine passes ``len(prompt) - 1`` so at least one suffix token is
        left to prefill — an empty prefill has no shape)."""
        now = self._clock_fn()
        nodes = self.index.walk(tokens, max_tokens)
        self.stats["lookups"] += 1
        if not nodes:
            self.stats["misses"] += 1
            if self.tel is not None:
                self.tel.event(now, "kv_lookup", hit=False, blocks=0,
                               tokens=0, **self.tel_attrs)
                self.tel.metrics.inc("kv_misses")
            return CacheHit(0)
        for n in nodes:
            self.pool.incref(n.block)
            n.block.hits += 1
            n.block.last_used = now
        n_tok = len(nodes) * self.block_size
        self.stats["hits"] += 1
        self.stats["tokens_reused"] += n_tok
        if self.tel is not None:
            self.tel.event(now, "kv_lookup", hit=True, blocks=len(nodes),
                           tokens=n_tok, **self.tel_attrs)
            self.tel.metrics.inc("kv_hits")
            self.tel.metrics.inc("kv_tokens_reused", n_tok)
        return CacheHit(n_tok, nodes)

    def release(self, hit: CacheHit) -> None:
        for n in hit.nodes:
            self.pool.decref(n.block)
        hit.nodes = []
        hit.n_tokens = 0

    # -- write path -----------------------------------------------------------
    def insert(self, tokens, payload_fn=None) -> int:
        """Index every whole-block span of ``tokens`` not cached yet.

        ``payload_fn(s0, s1)`` gives each admitted block's payload, the
        tokens ``[s0, s1)``: one whole block, ``s0`` a multiple of the
        block size.  Returns the number of newly admitted blocks.  Stops
        early when the pool is exhausted and nothing evictable remains
        (everything pinned): an interior gap would break the prefix
        property, so admission is strictly left-to-right.
        """
        now = self._clock_fn()
        bs = self.block_size
        node = self.index.root
        added = 0
        pinned: list[Block] = []     # keep the chain safe from self-eviction
        frontier = None              # eviction candidates, gathered once
        try:
            for i, span in enumerate(self.index._spans(tokens)):
                child = node.children.get(span)
                if child is not None:
                    node = child
                    self.pool.incref(node.block)
                    pinned.append(node.block)
                    continue
                blk = self.pool.alloc(now=now)
                if blk is None:
                    if frontier is None:
                        frontier = self._frontier(now)
                    if self._evict_next(frontier, now):
                        blk = self.pool.alloc(now=now)
                if blk is None:                 # pool fully pinned
                    self.stats["rejected"] += 1
                    break
                if payload_fn is not None:
                    blk.payload = payload_fn(i * bs, (i + 1) * bs)
                blk.depth = i + 1
                node = self.index.extend(node, span, blk)
                self.pool.incref(blk)
                pinned.append(blk)
                added += 1
        finally:
            for blk in pinned:
                self.pool.decref(blk)
        self.stats["inserts"] += added
        if self.tel is not None and added:
            self.tel.event(now, "kv_insert", blocks=added, **self.tel_attrs)
            self.tel.metrics.inc("kv_blocks_inserted", added)
        return added

    # -- eviction -------------------------------------------------------------
    def _block_value(self, blk: Block, now: float) -> float:
        if self._value_fn is not None:
            return self._value_fn(blk, now)
        return _default_value(blk, now)

    def _frontier(self, now: float) -> tuple[list, dict]:
        """The unpinned leaves, each scored once at ``now``, as a heap keyed
        by ``(value, place)`` (:meth:`PrefixIndex.leaves`), and the walk's
        places.  Popping it gives the victims, in their order, that
        re-walking and re-scoring the trie for each block would: the first
        lowest-value leaf of the walk.  That holds while ``now`` and what
        the value reads stay fixed and only this frontier's victims leave
        the trie, as within one insert, whose own new blocks are pinned."""
        leaves, places = self.index.leaves()
        heap = [(self._block_value(n.block, now), places[n], n)
                for n in leaves if n.block.refcount == 0]
        heapq.heapify(heap)
        return heap, places

    def _evict_next(self, frontier: tuple[list, dict], now: float) -> bool:
        """Free the frontier's next victim; its parent, left an unpinned
        leaf below the root, joins the frontier at its place.  False when
        the frontier is empty."""
        heap, places = frontier
        if not heap:
            return False
        _, place, victim = heapq.heappop(heap)
        parent = victim.parent
        self.index.remove(victim)
        self.pool.free(victim.block)
        self.stats["evictions"] += 1
        if self.tel is not None:
            self.tel.event(now, "kv_evict", blocks=1,
                           depth=victim.block.depth, **self.tel_attrs)
            self.tel.metrics.inc("kv_evictions")
        if parent is not self.index.root and not parent.children \
                and parent.block.refcount == 0:
            heapq.heappush(heap, (self._block_value(parent.block, now),
                                  self.index.place(places, parent, place),
                                  parent))
        return True

    def _evict(self, need: int) -> bool:
        """Free ``need`` blocks, the lowest-value unpinned leaves first
        (a removed leaf may expose its parent).  False when nothing
        evictable remains."""
        now = self._clock_fn()
        frontier = self._frontier(now)
        return all(self._evict_next(frontier, now) for _ in range(need))

    # -- introspection ---------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        return self.stats["hits"] / max(self.stats["lookups"], 1)

    def __len__(self) -> int:
        return len(self.index)


class CombinedPrefixIndex:
    """Duck-typed prefix index over many per-unit caches (a live view of a
    ``mid -> PrefixKVCache`` dict): the best match across every unit.

    With per-unit KV caches (heterogeneous-fleet engines, per-machine
    simulator mode) the SimilarityDetector's PREFIX level still needs one
    engine-wide score for admission accounting and cross-plane routing —
    the deepest prefix *any* unit holds — while the per-machine
    ``MappingContext.prefix_overlap`` term reads each unit's own index to
    discriminate within the pool."""

    def __init__(self, caches: dict):
        self._caches = caches       # shared with the owner; never copied

    def match_len(self, tokens, max_tokens: int | None = None) -> int:
        return max((c.index.match_len(tokens, max_tokens)
                    for c in self._caches.values()), default=0)
