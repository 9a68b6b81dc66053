"""Block pool: the physical half of the paged KV prefix cache (DESIGN.md §2.4).

A pool owns ``n_blocks`` fixed-size block slots, each holding the KV tensors
for ``block_size`` consecutive prompt tokens (the payload is opaque to the
pool — the serving engine stores host-side ``(k, v)`` arrays, the simulator
stores nothing).  Blocks are refcounted: a block is pinned while any
in-flight execution reads it, and the pool refuses to free a pinned block —
the invariant the prefix-cache tests assert.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Block", "BlockPool"]


@dataclass
class Block:
    bid: int
    payload: object = None          # engine: (k, v) host arrays; sim: None
    refcount: int = 0
    # reuse-economics metadata (drives value-based eviction) ---------------
    n_tokens: int = 0
    depth: int = 0                  # 1-based trie depth: a hit on this block
                                    # reuses depth*block_size prefix tokens
    hits: int = 0                   # lookups that traversed this block
    created_at: float = 0.0
    last_used: float = 0.0
    in_use: bool = field(default=False)  # allocated (vs on the free list)


class BlockPool:
    """Preallocated, refcounted pool of fixed-size KV block slots."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError("n_blocks and block_size must be positive")
        self.block_size = block_size
        self.blocks = [Block(bid=i) for i in range(n_blocks)]
        self._free = list(range(n_blocks - 1, -1, -1))

    # -- capacity -----------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - self.n_free

    # -- alloc / free ---------------------------------------------------------
    def alloc(self, payload=None, n_tokens: int | None = None,
              now: float = 0.0) -> Block | None:
        """Take a free slot; ``None`` when the pool is exhausted (the caller
        must evict first)."""
        if not self._free:
            return None
        blk = self.blocks[self._free.pop()]
        blk.payload = payload
        blk.refcount = 0
        blk.n_tokens = self.block_size if n_tokens is None else n_tokens
        blk.hits = 0
        blk.created_at = now
        blk.last_used = now
        blk.in_use = True
        return blk

    def free(self, blk: Block) -> None:
        """Return a block to the free list.  Refuses pinned blocks."""
        if blk.refcount != 0:
            raise RuntimeError(
                f"block {blk.bid} freed while referenced (rc={blk.refcount})")
        if not blk.in_use:
            raise RuntimeError(f"double free of block {blk.bid}")
        blk.payload = None
        blk.in_use = False
        self._free.append(blk.bid)

    # -- pinning --------------------------------------------------------------
    def incref(self, blk: Block) -> None:
        if not blk.in_use:
            raise RuntimeError(f"incref on free block {blk.bid}")
        blk.refcount += 1

    def decref(self, blk: Block) -> None:
        if blk.refcount <= 0:
            raise RuntimeError(f"decref on unreferenced block {blk.bid}")
        blk.refcount -= 1
