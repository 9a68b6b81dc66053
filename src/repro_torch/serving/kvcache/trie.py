"""Prefix index: the logical half of the paged KV prefix cache.

A radix trie over token ids at *block* granularity: each edge is labelled
with one block's worth of token ids (a tuple of ``block_size`` ints), each
node owns the pool block holding that span's KV.  A new request walks the
trie block-by-block; the depth reached is the cached-prefix length, and the
visited nodes name exactly the pool blocks the execution can attach to.

Only whole blocks are indexed: a prompt of 70 tokens with block size 16
contributes 4 edges (64 tokens); the tail fragment is always recomputed.
This is what makes cross-request reuse sound — RoPE bakes absolute
positions into cached K, so a span is only reusable as a *prefix* starting
at position ``depth * block_size``, which the trie walk guarantees.
"""

from __future__ import annotations

from .pool import Block

__all__ = ["TrieNode", "PrefixIndex"]


class TrieNode:
    __slots__ = ("children", "parent", "edge", "block")

    def __init__(self, parent: "TrieNode | None" = None,
                 edge: tuple | None = None, block: Block | None = None):
        self.children: dict[tuple, TrieNode] = {}
        self.parent = parent
        self.edge = edge            # the block-sized token tuple keying us
        self.block = block          # pool block holding this span's KV

    @property
    def depth(self) -> int:
        d, n = 0, self
        while n.parent is not None:
            d, n = d + 1, n.parent
        return d

    def is_leaf(self) -> bool:
        return not self.children


class PrefixIndex:
    """Block-granular radix trie over token-id sequences."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = TrieNode()
        self._n_nodes = 0

    def __len__(self) -> int:
        return self._n_nodes

    # -- walking --------------------------------------------------------------
    def _spans(self, tokens, max_tokens: int | None = None):
        """Whole-block token tuples covering ``tokens[:max_tokens]``."""
        bs = self.block_size
        n = len(tokens) if max_tokens is None else min(len(tokens), max_tokens)
        for i in range(n // bs):
            yield tuple(tokens[i * bs:(i + 1) * bs])

    def walk(self, tokens, max_tokens: int | None = None) -> list[TrieNode]:
        """Nodes along the longest cached prefix of ``tokens``."""
        node, path = self.root, []
        for span in self._spans(tokens, max_tokens):
            child = node.children.get(span)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def match_len(self, tokens, max_tokens: int | None = None) -> int:
        """Length (in tokens) of the longest cached prefix — the PREFIX-level
        similarity score consumed by the admission gate."""
        return len(self.walk(tokens, max_tokens)) * self.block_size

    # -- mutation -------------------------------------------------------------
    def extend(self, node: TrieNode, span: tuple, block: Block) -> TrieNode:
        """Attach a new child holding ``block`` under ``node``."""
        child = TrieNode(parent=node, edge=span, block=block)
        node.children[span] = child
        self._n_nodes += 1
        return child

    def remove(self, node: TrieNode) -> None:
        """Detach a leaf node (its block must already be unpinned)."""
        if node.children:
            raise RuntimeError("cannot remove an internal trie node")
        if node.parent is None:
            raise RuntimeError("cannot remove the trie root")
        del node.parent.children[node.edge]
        node.parent = None
        self._n_nodes -= 1

    def leaves(self) -> tuple[list[TrieNode],
                              dict[TrieNode, tuple[int, int]]]:
        """All removable frontier nodes (eviction candidates), and the
        places the walk records: where a node stands in their order as a
        leaf, ``(pop rank of its parent, index among its siblings)``, for
        each leaf and each node with siblings (:meth:`place` gives an only
        child's).  The leaves come in the order of their places: the leaf
        children of each node the walk pops, in the order they were added.

        Removing a leaf, or extending a chain, keeps the relative order of
        the other nodes' places as a later walk would give it, so a node
        that becomes a leaf later sorts among the others by its place at
        this walk."""
        out, places, stack, rank = [], {}, [self.root], 0
        while stack:
            n = stack.pop()
            # down a chain of only children: each is popped as it is pushed
            while len(n.children) == 1:
                (c,) = n.children.values()
                rank += 1
                if not c.children:
                    places[c] = (rank - 1, 0)
                    out.append(c)
                    break
                n = c
            else:
                for i, c in enumerate(n.children.values()):
                    places[c] = (rank, i)
                    if c.children:
                        stack.append(c)
                    else:
                        out.append(c)
                rank += 1
        return out, places

    @staticmethod
    def place(places: dict, node: TrieNode,
              child: tuple[int, int]) -> tuple[int, int]:
        """``node``'s place at the :meth:`leaves` walk that recorded
        ``places``, once its last child, whose place was ``child``, has
        gone.  An only child has none recorded: the walk pops it right
        after its parent, so it stands at ``(its own pop rank - 1, 0)``,
        and its pop rank is the first of its children's places."""
        return places.get(node, (child[0] - 1, 0))
