"""The port's twin of ``tests/test_kvcache.py``: the paged KV prefix
cache's pool/trie/facade invariants and the simulator's analytical reuse
model, on ``repro_torch.serving.kvcache`` and ``repro_torch.core``.

Each case runs its body on the port and on the reference
(``repro.serving.kvcache``, ``repro.core``) with the same inputs
(``torch_jax_side.both``): the same errors, pool counts, match lengths,
hits, evictions and cache stats on both, and the same simulator stats,
before it checks the reference's invariants on the port's.  Every
simulator runs on ``device="cpu"``."""

import numpy as np
import pytest

from torch_jax_side import both


# ---------------------------------------------------------------------------
# block pool
# ---------------------------------------------------------------------------

class TestBlockPool:
    def test_alloc_free_roundtrip(self):
        def run(s):
            pool = s.BlockPool(4, 16)
            blk = pool.alloc(payload="kv")
            held = (pool.n_used, blk.payload)
            pool.free(blk)
            return held, (pool.n_used, blk.payload)

        assert both(run) == ((1, "kv"), (0, None))

    def test_never_freed_while_referenced(self):
        def run(s):
            pool = s.BlockPool(2, 16)
            blk = pool.alloc()
            pool.incref(blk)
            with pytest.raises(RuntimeError, match="referenced"):
                pool.free(blk)
            pool.decref(blk)
            pool.free(blk)          # now legal
            return pool.n_used, blk.refcount

        assert both(run) == (0, 0)

    def test_double_free_and_stray_refs_rejected(self):
        def run(s):
            pool = s.BlockPool(2, 16)
            blk = pool.alloc()
            pool.free(blk)
            with pytest.raises(RuntimeError, match="double free"):
                pool.free(blk)
            with pytest.raises(RuntimeError):
                pool.incref(blk)
            blk2 = pool.alloc()
            with pytest.raises(RuntimeError):
                pool.decref(blk2)
            return pool.n_used

        assert both(run) == 1

    def test_exhaustion_returns_none(self):
        def run(s):
            pool = s.BlockPool(2, 16)
            return [pool.alloc() is not None for _ in range(3)]

        assert both(run) == [True, True, False]


# ---------------------------------------------------------------------------
# prefix trie
# ---------------------------------------------------------------------------

class TestPrefixIndex:
    def test_block_granular_match(self):
        def run(s):
            idx = s.PrefixIndex(4)
            pool = s.BlockPool(8, 4)
            toks = tuple(range(10))       # 2 whole blocks + 2-token tail
            node = idx.root
            for span in idx._spans(toks):
                node = idx.extend(node, span, pool.alloc())
            return [idx.match_len(toks), idx.match_len(toks[:7]),
                    idx.match_len((99,) + toks[1:]),
                    idx.match_len(toks, max_tokens=7)]

        # tail fragment never indexed
        assert both(run) == [8, 4, 0, 4]

    def test_remove_leaf_only(self):
        def run(s):
            idx = s.PrefixIndex(2)
            pool = s.BlockPool(4, 2)
            a = idx.extend(idx.root, (1, 2), pool.alloc())
            b = idx.extend(a, (3, 4), pool.alloc())
            with pytest.raises(RuntimeError):
                idx.remove(a)             # internal node
            idx.remove(b)
            idx.remove(a)                 # now a leaf
            return len(idx)

        assert both(run) == 0


# ---------------------------------------------------------------------------
# cache facade
# ---------------------------------------------------------------------------

class TestPrefixKVCache:
    def test_lookup_insert_shared_prefix(self):
        def run(s):
            c = s.PrefixKVCache(16, 4)
            sys_p = tuple(range(8))
            c.insert(sys_p + (50, 51, 52, 53))
            c.insert(sys_p + (60, 61, 62, 63))
            used = c.pool.n_used
            hit = c.lookup(sys_p + (70, 71, 72, 73))
            n = hit.n_tokens
            c.release(hit)
            return used, n, dict(c.stats)

        used, n, _ = both(run)
        # the shared 8-token prefix is stored once: 2 + 1 + 1 blocks
        assert used == 4
        assert n == 8

    def test_lookup_pins_blocks_against_eviction(self):
        def run(s):
            c = s.PrefixKVCache(2, 4)
            p1 = tuple(range(8))          # fills the pool
            c.insert(p1)
            hit = c.lookup(p1, max_tokens=len(p1) - 1)
            # p1's unpinned tail block is evictable, the pinned head is
            # not: a conflicting insert admits one block then gets
            # rejected, and must never free KV the outstanding hit reads
            p2 = (99,) + tuple(range(100, 107))
            log = [hit.n_tokens, c.insert(p2), c.stats["rejected"],
                   c.peek(p1), hit.blocks[0].in_use,
                   hit.blocks[0].refcount]
            c.release(hit)
            log += [c.insert(p2), c.stats["evictions"], c.peek(p2),
                    dict(c.stats)]
            return log

        log = both(run)
        assert log[0] == 4                # capped to leave a suffix
        assert log[1] == 1 and log[2] == 1
        assert log[3] == 4                # pinned head survived
        assert log[4] and log[5] == 1
        assert log[6] == 1                # evictable now
        assert log[7] == 2
        assert log[8] == 8

    def test_release_makes_hit_inert(self):
        def run(s):
            c = s.PrefixKVCache(4, 4)
            c.insert(tuple(range(8)))
            hit = c.lookup(tuple(range(8)))
            c.release(hit)
            return (bool(hit), hit.blocks,
                    [b.refcount for b in c.pool.blocks])

        inert, blocks, refs = both(run)
        assert not inert and blocks == []
        assert all(r == 0 for r in refs)

    def test_eviction_prefers_low_value(self):
        def run(s):
            now = [0.0]
            c = s.PrefixKVCache(2, 4, clock_fn=lambda: now[0])
            c.insert(tuple(range(4)))         # block A at t=0
            now[0] = 100.0
            c.insert(tuple(range(100, 104)))  # block B at t=100
            h = c.lookup(tuple(range(100, 104)))   # B hit: more valuable
            c.release(h)
            now[0] = 101.0
            c.insert(tuple(range(200, 204)))  # must evict stale A, not hot B
            return (c.peek(tuple(range(100, 104))), c.peek(tuple(range(4))),
                    dict(c.stats))

        hot, stale, _ = both(run)
        assert hot == 4
        assert stale == 0

    def test_insert_larger_than_pool(self):
        def run(s):
            c = s.PrefixKVCache(3, 2)
            added = c.insert(tuple(range(10)))     # 5 spans, 3 slots
            return added, c.peek(tuple(range(10)))

        added, kept = both(run)
        assert added == 3                      # strict left-to-right prefix
        assert kept == 6

    def test_payload_fn_called_only_for_new_blocks(self):
        def run(s):
            calls = []
            c = s.PrefixKVCache(8, 4)
            c.insert(tuple(range(8)), lambda a, e: calls.append((a, e)))
            c.insert(tuple(range(12)), lambda a, e: calls.append((a, e)))
            return calls

        assert both(run) == [(0, 4), (4, 8), (8, 12)]


# ---------------------------------------------------------------------------
# eviction: one pass per insert, the reference's victims in its order
# ---------------------------------------------------------------------------

#: residency values for the eviction tests: the facade's default, one that
#: buckets depth as the engine's estimator does (ties among leaves of a
#: quantum), one of two classes (a victim's parent rarely the next victim,
#: so where it joins the ties matters), and a flat one that leaves every
#: choice to the tie rule
VALUES = {
    "default": None,
    "bucketed": lambda blk, now: float(max(blk.depth, 1).bit_length())
    * (1.0 + blk.hits) / max(now - blk.last_used, 1.0),
    "parity": lambda blk, now: float(blk.depth % 2),
    "flat": lambda blk, now: 0.0,
}


#: a chain's leaf beside a node popped after it: the walk's ranks make the
#: leaf's place sort before that node's first child, where equal values
#: leave the order to the places alone
CHAIN = (7, 1, [("insert", (1, 10)), ("insert", (1, 11)),
                ("insert", (2, 20, 21)),
                ("insert", (3, 30, 31, 32, 33, 34, 35)),
                ("pin_all",), ("insert", (4, 40))])


def _eviction_ops(seed):
    """A seeded pool geometry and sequence of inserts, pinned lookups held
    across inserts, releases, a pinning of everything cached (the
    ``rejected`` path) and clock steps, some of them 0 (equal
    ``last_used``).  Prompts share prefixes (a few bases, a small
    vocabulary) and some are longer than the pool.  ``"chain"`` is
    :data:`CHAIN`."""
    if seed == "chain":
        return CHAIN
    rng = np.random.default_rng(seed)
    n_blocks, bs = int(rng.integers(8, 65)), int(rng.integers(2, 5))
    bases = [tuple(rng.integers(0, 4, size=int(rng.integers(0, 6 * bs)))
                   .tolist()) for _ in range(4)]
    ops, prompts = [], []
    for _ in range(80):
        r = rng.random()
        if r < 0.1:
            ops.append(("release",))
        elif r < 0.13:
            ops.append(("pin_all",))
        else:
            if prompts and rng.random() < 0.4:    # a sibling of an earlier
                old = prompts[int(rng.integers(0, len(prompts)))]
                head = old[:bs * int(rng.integers(0, len(old) // bs + 1))]
                n = int(rng.integers(1, 3 * bs))
            else:
                head = bases[int(rng.integers(0, 4))] \
                    if rng.random() < 0.7 else ()
                n = int(rng.integers(1, (n_blocks + 6) * bs))
            prompt = head + tuple(rng.integers(0, 4, size=n).tolist())
            prompts.append(prompt)
            ops.append(("lookup" if r < 0.35 else "insert", prompt))
        ops.append(("tick", float(rng.choice([0.0, 0.0, 1.0, 7.5]))))
    return n_blocks, bs, ops


def _trie(c):
    """The trie's nodes in walk order: depth, edge and block state."""
    out, stack = [], [(c.index.root, 0)]
    while stack:
        n, d = stack.pop()
        for ch in n.children.values():
            b = ch.block
            out.append((d + 1, ch.edge, b.bid, b.depth, b.refcount, b.hits,
                        b.last_used))
            stack.append((ch, d + 1))
    return out


@pytest.mark.parametrize("value", sorted(VALUES))
@pytest.mark.parametrize("seed", [*range(8), "chain"])
def test_eviction_matches_the_reference(seed, value):
    """Seeded insert and lookup sequences on small pools: the port's cache
    evicts the reference's blocks in its order, ties included, admits as
    many blocks, keeps the same stats, events and counters, and holds the
    same trie after every operation."""
    n_blocks, bs, ops = _eviction_ops(seed)

    def run(s):
        now = [0.0]
        c = s.PrefixKVCache(n_blocks, bs, value_fn=VALUES[value],
                            clock_fn=lambda: now[0])
        c.tel, c.tel_attrs = s.Telemetry(), {"machine": 1}
        victims, log, held, seen = [], [], [], []
        remove = c.index.remove

        def record(node):
            victims.append((node.edge, node.block.depth))
            remove(node)
        c.index.remove = record
        for op in ops:
            if op[0] == "tick":
                now[0] += op[1]
                continue
            if op[0] == "insert":
                seen.append(op[1])
                out = c.insert(op[1], lambda a, e: (a, e))
            elif op[0] == "lookup":
                hit = c.lookup(op[1], max_tokens=len(op[1]) - 1)
                held.append(hit)
                out = hit.n_tokens
            elif op[0] == "release":
                out = len(held)
                while held:
                    c.release(held.pop())
            else:
                held += [c.lookup(p) for p in seen]
                out = sum(h.n_tokens for h in held)
            log.append((op[0], out, dict(c.stats), _trie(c),
                        len(victims)))
        return (victims, log, c.tel.comparable_events(),
                c.tel.metrics.snapshot()["counters"])

    victims, log, _, _ = both(run)
    # not vacuous: blocks were evicted, and an insert met a pinned pool
    assert victims and log[-1][2]["rejected"] > 0


def test_eviction_walks_and_scores_once_per_insert():
    """A full 3,072-block pool of 16-token blocks: a 2,048-token unique
    prompt evicts 128 blocks with one walk of the trie, and scores each
    candidate once (the frontier, and each parent its victims expose)."""
    from torch_jax_side import PORT
    rng = np.random.default_rng(5)
    calls = [0]

    def value(blk, now):
        calls[0] += 1
        return (1.0 + blk.hits) / max(now - blk.last_used, 1.0)
    now = [0.0]
    c = PORT.PrefixKVCache(3072, 16, value_fn=value, clock_fn=lambda: now[0])
    shared = tuple(rng.integers(0, 50_000, size=512).tolist())
    while c.pool.n_free:
        n = int(rng.integers(512, 6144))
        head = shared[:int(rng.integers(0, 512))] if rng.random() < 0.5 \
            else ()
        c.insert(head + tuple(rng.integers(0, 50_000, size=n).tolist()))
        now[0] += 1.0
    walks = []
    leaves = c.index.leaves

    def counted(*a):
        out = leaves(*a)
        walks.append(len(out[0]))
        return out
    c.index.leaves = counted
    calls[0] = 0
    ev0 = c.stats["evictions"]
    prompt = tuple(rng.integers(50_000, 100_000, size=2048).tolist())
    assert c.insert(prompt) == 128
    evicted = c.stats["evictions"] - ev0
    assert evicted == 128 and len(walks) == 1
    assert walks[0] > 1
    assert calls[0] <= walks[0] + evicted
    assert c.peek(prompt) == 2048


# ---------------------------------------------------------------------------
# PREFIX merge level
# ---------------------------------------------------------------------------

def test_prefix_merge_level():
    def run(s):
        return (s.MergeLevel.PREFIX < s.MergeLevel.DATA_ONLY,
                s.MergeLevel.PREFIX.label,
                [s.common_prefix_len(a, b) for a, b in (
                    ((1, 2, 3, 4), (1, 2, 9)), ((1, 2), (1, 2, 3)),
                    ((9,), (1,)))])

    assert both(run) == (True, "prefix", [2, 2, 0])


# ---------------------------------------------------------------------------
# simulator analytical model
# ---------------------------------------------------------------------------

def _prefix_tasks(side, n=200, n_prefixes=6, seed=0):
    rng = np.random.default_rng(seed)
    prefixes = [tuple(rng.integers(0, 1000, size=48).tolist())
                for _ in range(n_prefixes)]
    out, t = [], 0.0
    for i in range(n):
        pi = min(int(rng.zipf(1.5)) - 1, n_prefixes - 1)
        toks = prefixes[pi] + tuple(rng.integers(0, 1000, size=16).tolist())
        out.append(side.Task(ttype="generate", data_id=f"d{i}",
                             op="generate", arrival=t, deadline=t + 400,
                             tokens=toks))
        t += float(rng.exponential(4))
    return out


def _run_sim(blocks, seed=0):
    """The prefix-reuse simulator run on both packages: the port's stats,
    held equal to the reference's."""
    def run(s):
        pet = s.PETMatrix.generate(["generate"], ["m0"],
                                   np.random.default_rng(7),
                                   mean_range=(15, 25))
        sim = s.Simulator(_prefix_tasks(s, seed=seed),
                          [s.Machine(mid=i) for i in range(3)],
                          s.PETOracle(pet, seed=3),
                          s.SimConfig(prefix_cache_blocks=blocks,
                                      kv_block_size=16), **s.dev)
        return sim.run()

    return both(run)


class TestSimulatorPrefixReuse:
    def test_disabled_by_default(self):
        st = _run_sim(0)
        assert st.prefix_hits == 0 and st.prefix_time_saved == 0.0

    def test_reuse_saves_time_and_scales_with_capacity(self):
        st0 = _run_sim(0)
        st_small = _run_sim(8)
        st_big = _run_sim(128)
        assert st_small.prefix_hits > 0
        assert st_big.prefix_hits >= st_small.prefix_hits
        assert st_big.busy_time < st_small.busy_time < st0.busy_time
        assert st_small.prefix_evictions > 0
        assert st_big.prefix_tokens_reused >= st_small.prefix_tokens_reused

    def test_no_dangling_refs_after_run(self):
        def run(s):
            pet = s.PETMatrix.generate(["generate"], ["m0"],
                                       np.random.default_rng(7))
            sim = s.Simulator(_prefix_tasks(s, n=80), [s.Machine(mid=0)],
                              s.PETOracle(pet, seed=3),
                              s.SimConfig(prefix_cache_blocks=16,
                                          kv_block_size=16), **s.dev)
            st = sim.run()
            return st, [b.refcount for b in sim.kvcache.pool.blocks]

        st, refs = both(run)
        assert st.prefix_hits > 0
        assert all(r == 0 for r in refs)
