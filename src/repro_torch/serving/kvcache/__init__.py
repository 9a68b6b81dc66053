"""Paged KV prefix cache: cross-request computational reuse (DESIGN.md §2.4).

The dissertation's function-reuse idea extended across time: instead of
merging only tasks that coincide in one batch window, completed prefills
leave their KV behind in a refcounted block pool indexed by a token-id
radix trie, and any later request prefills only the uncached *suffix* of
its prompt.  Used by both the live serving engine (real KV payloads) and
the discrete-event simulator (analytical, payload-free).
"""

from .cache import CacheHit, CombinedPrefixIndex, PrefixKVCache
from .migrate import MigrationResult, TransferCostModel, migrate, migration_cost
from .pool import Block, BlockPool
from .trie import PrefixIndex, TrieNode

__all__ = ["Block", "BlockPool", "CacheHit", "CombinedPrefixIndex",
           "MigrationResult", "PrefixIndex", "PrefixKVCache",
           "TransferCostModel", "TrieNode", "migrate", "migration_cost"]
