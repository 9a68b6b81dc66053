"""KV block migration between :class:`PrefixKVCache` instances (§2.13).

The disaggregated serving path (prefill-specialized planes feeding decode
planes) and unit retirement both need to move cached prefixes between
per-unit caches without recomputing them.  :func:`migrate` copies block
runs trie-to-trie: parents strictly before children, so the destination
never holds a span whose prefix is missing — the same left-to-right
admission invariant ``PrefixKVCache.insert`` maintains.  Payloads are
copied *by reference* (the engine's host ``(k, v)`` arrays are immutable
once inserted; the simulator stores ``None``), and hit attribution
(``hits``, ``created_at``, ``last_used``) rides along so value-based
eviction on the destination sees the blocks' real history, not a fresh
birth.

The transfer is priced by :class:`TransferCostModel` — a fleet-derived
per-block cost (link setup + per-token payload movement, scaled by the
slower endpoint's speed).  The simulator charges this model analytically;
the live engine charges the same model for decision parity and then pays
the real page-arena copy.  No JAX imports here — this module must stay
importable by the pure-numpy simulation path.
"""

from __future__ import annotations

from dataclasses import dataclass

from .cache import PrefixKVCache

__all__ = ["MigrationResult", "TransferCostModel", "migrate",
           "migration_cost"]


@dataclass(frozen=True)
class TransferCostModel:
    """Per-migration virtual-time cost: ``base`` link setup plus a
    per-token payload term scaled by the slower endpoint.  Derived from
    the fleet catalog (machine ``speed``), not measured — both substrates
    must price a transfer identically for decision-trace equivalence."""

    base_cost: float = 0.5          # link setup / scheduling overhead
    per_token: float = 0.01         # payload movement per cached token

    def cost(self, n_blocks: int, block_size: int,
             src_speed: float = 1.0, dst_speed: float = 1.0) -> float:
        if n_blocks <= 0:
            return 0.0
        bw = min(max(src_speed, 1e-9), max(dst_speed, 1e-9))
        return self.base_cost + n_blocks * block_size * self.per_token / bw


@dataclass
class MigrationResult:
    blocks: int = 0        # newly admitted on dst (actually transferred)
    tokens: int = 0        # token payload moved (bytes-equivalent proxy)
    skipped: int = 0       # spans dst already held (attribution merged)
    dropped: int = 0       # spans lost to dst pool exhaustion
    cost: float = 0.0      # modeled transfer cost for ``blocks``


def migration_cost(src: PrefixKVCache, dst: PrefixKVCache, tokens,
                   cost_model: TransferCostModel,
                   src_speed: float = 1.0, dst_speed: float = 1.0) -> float:
    """Pre-migration price of moving ``tokens``'s cached chain src→dst:
    only spans the destination does not already hold transfer."""
    bs = src.block_size
    n_src = src.index.match_len(tokens) // bs
    n_dst = dst.index.match_len(tokens) // bs
    return cost_model.cost(max(0, n_src - n_dst), bs, src_speed, dst_speed)


def _copy_block(src, dst, node, dst_parent, now):
    """Admit one src trie node into dst under ``dst_parent``; None when the
    destination pool is exhausted even after eviction."""
    blk = dst.pool.alloc(now=now)
    if blk is None and dst._evict(1):
        blk = dst.pool.alloc(now=now)
    if blk is None:
        return None
    sb = node.block
    blk.payload = sb.payload            # by reference: payloads are immutable
    blk.n_tokens = sb.n_tokens
    blk.depth = sb.depth
    blk.hits = sb.hits
    blk.created_at = sb.created_at
    blk.last_used = max(sb.last_used, now)
    return dst.index.extend(dst_parent, node.edge, blk)


def migrate(src: PrefixKVCache, dst: PrefixKVCache, tokens=None, *,
            cost_model: TransferCostModel | None = None,
            src_speed: float = 1.0, dst_speed: float = 1.0,
            release_src: bool = True, now: float | None = None,
            src_mid=None, dst_mid=None, tel=None) -> MigrationResult:
    """Move cached block runs from ``src`` into ``dst``.

    ``tokens`` selects one root-to-deepest chain (the prefill→decode
    handoff path); ``None`` migrates the whole trie (unit retirement).
    Spans already present on ``dst`` are not re-admitted — their hit
    attribution is merged instead.  When the destination pool exhausts
    mid-path the rest of that subtree is dropped (an interior gap would
    break the prefix property).  With ``release_src`` the migrated spans
    are freed on ``src`` bottom-up; blocks still pinned by in-flight
    readers are copied but left in place.
    """
    if src.block_size != dst.block_size:
        raise ValueError(
            f"block_size mismatch: src={src.block_size} dst={dst.block_size}")
    if now is None:
        now = src._clock_fn()
    res = MigrationResult()

    # pre-order: parents strictly before children (prefix property)
    if tokens is not None:
        order = src.index.walk(tokens)
    else:
        order, stack = [], [src.index.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                order.append(c)
                stack.append(c)

    mapped = {src.index.root: dst.index.root}
    pinned = []                      # keep new dst chain safe from self-evict
    try:
        for node in order:
            dst_parent = mapped.get(node.parent)
            if dst_parent is None:           # ancestor dropped: gap, skip
                res.dropped += 1
                continue
            child = dst_parent.children.get(node.edge)
            if child is not None:            # dst already holds this span
                child.block.hits += node.block.hits
                child.block.last_used = max(child.block.last_used,
                                            node.block.last_used, now)
                res.skipped += 1
            else:
                child = _copy_block(src, dst, node, dst_parent, now)
                if child is None:            # dst pool fully pinned
                    res.dropped += 1
                    dst.stats["rejected"] += 1
                    continue
                res.blocks += 1
                res.tokens += child.block.n_tokens
            mapped[node] = child
            dst.pool.incref(child.block)
            pinned.append(child.block)
    finally:
        for blk in pinned:
            dst.pool.decref(blk)

    if release_src:
        # bottom-up: freeing a child may expose its parent as a leaf
        for node in reversed(order):
            if node in mapped and node.is_leaf() and \
                    node.block.refcount == 0 and node.parent is not None:
                blk = node.block
                src.index.remove(node)
                src.pool.free(blk)

    if cost_model is not None:
        res.cost = cost_model.cost(res.blocks, src.block_size,
                                   src_speed, dst_speed)
    moved = res.blocks + res.skipped
    src.stats["migrated_out"] += moved
    dst.stats["migrated_in"] += moved
    tel = tel if tel is not None else (src.tel or dst.tel)
    if tel is not None and (res.blocks or res.skipped or res.dropped):
        tel.event(now, "kv_migrate", blocks=res.blocks, tokens=res.tokens,
                  skipped=res.skipped, dropped=res.dropped,
                  cost=round(res.cost, 9), src=src_mid, dst=dst_mid)
        tel.metrics.inc("kv_migrations")
        if res.blocks:
            tel.metrics.inc("kv_blocks_migrated", res.blocks)
    return res
