"""The traffic generator: repeats by seed, stratified sizes, the mixes'
shapes."""

import pytest

from perfbench import bench
from perfbench.traffic import Traffic, poisson_times, quantiles, zipf_counts

MIXES = ("longdoc", "shared_docs", "docqa")


def mix(name):
    return bench.load_json(bench.PB / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = Traffic(mix(name), 2**31 + 7, 1000), Traffic(mix(name), 2**31 + 7,
                                                         1000)
    for k in range(150):
        sa, sb = a.spec(k), b.spec(k)
        assert (sa.prompt, sa.n_new, sa.deadline_ms) == \
            (sb.prompt, sb.n_new, sb.deadline_ms)
    if not a.closed:
        assert [a.arrival(k) for k in range(50)] == \
            [b.arrival(k) for k in range(50)]


def shape(t, n):
    return [(len(t.spec(k).prompt), t.spec(k).n_new, t.spec(k).repeat_of,
             t.spec(k).doc) for k in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_same_work_in_another_order(name):
    m = mix(name)
    a, b = Traffic(m, 1, 1000), Traffic(m, 2, 1000)
    n = 3 * m["strata"]
    # the seed draws the order, the documents' picks, the repeats and the
    # arrivals ...
    assert shape(a, n) != shape(b, n)
    assert a.spec(0).prompt != b.spec(0).prompt
    if not a.closed:
        assert a.arrival(40) != b.arrival(40)
    # ... of the same set of sizes in every block
    if "repeat_share" not in m:
        for blk in range(3):
            ks = range(blk * m["strata"], (blk + 1) * m["strata"])
            for size in (lambda s: s.n_new, lambda s: len(s.prompt)):
                assert sorted(size(a.spec(k)) for k in ks) == \
                    sorted(size(b.spec(k)) for k in ks)
    assert sorted(len(d) for d in a.docs) == sorted(len(d) for d in b.docs)


@pytest.mark.parametrize("name", MIXES)
def test_each_block_holds_the_same_sizes(name):
    m = mix(name)
    t = Traffic(m, 3, 1000)
    n = m["strata"]
    blocks = [sorted(t.spec(k).n_new for k in range(b * n, (b + 1) * n)
                     if t.spec(k).repeat_of < 0) for b in range(3)]
    if "repeat_share" not in m:
        assert blocks[0] == blocks[1] == blocks[2]


def test_lengths_within_the_mix_limits():
    for name in MIXES:
        m = mix(name)
        t = Traffic(m, 5, 64000)
        docs = [len(d) for d in t.docs]
        for k in range(200):
            s = t.spec(k)
            body = len(s.prompt) - (docs[s.doc] if s.doc >= 0 else 0)
            assert m["prompt"]["min"] <= body <= m["prompt"]["max"]
            assert m["output"]["min"] <= s.n_new <= m["output"]["max"]
            assert all(0 < x < 64000 for x in s.prompt)


def test_shared_docs_repeats_and_zipf():
    m = mix("shared_docs")
    t = Traffic(m, 9, 1000)
    n = 10 * m["strata"]
    specs = [t.spec(k) for k in range(n)]
    reps = [s for s in specs if s.repeat_of >= 0]
    assert abs(len(reps) / n - m["repeat_share"]) < 0.01
    for s in reps:
        src = specs[s.repeat_of]
        assert (s.prompt, s.n_new) == (src.prompt, src.n_new)
        assert 1 <= s.index - s.repeat_of <= m["repeat_window"]
    cnt = zipf_counts(8, 1.0, 64)
    assert sum(cnt) == 64 and cnt == sorted(cnt, reverse=True)
    assert len(t.docs) == 8
    assert all(2048 <= len(d) <= 4096 for d in t.docs)


def test_quantiles_and_poisson():
    q = quantiles({"dist": "lognormal", "median": 2048, "sigma": 0.55,
                   "min": 512, "max": 6144}, 64)
    assert q == sorted(q) and q[31] < 2048 < q[32]
    import numpy as np
    g = poisson_times(np.random.default_rng(0), 4.0)
    ts = [next(g) for _ in range(4000)]
    assert ts == sorted(ts) and abs(ts[-1] / 4000 - 0.25) < 0.02
