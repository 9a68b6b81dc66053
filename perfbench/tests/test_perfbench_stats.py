"""The end-to-end metrics are taken over every request and all the time
of the window: a stall anywhere in it moves them."""

import pytest

from perfbench import stats


def stream(stall_at=None, stall_s=0.0, n=400, gap=0.05, service=0.2):
    """Requests due every ``gap`` seconds, each answered ``service``
    seconds later; a stall of ``stall_s`` at ``stall_at`` delays every
    answer from then on by its length, as a server that never catches up
    would."""
    recs = []
    for i in range(n):
        due = i * gap
        done = due + service
        if stall_at is not None and done >= stall_at:
            done += stall_s
        recs.append({"index": i, "due": due, "done": done, "outcome": "done",
                     "prompt": 100, "served": 10, "deadline_ms": 400.0,
                     "merged": False})
    return recs


def test_percentile_is_exact_and_interpolated():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


@pytest.mark.parametrize("where", [2.0, 9.5, 15.0])
def test_a_stall_anywhere_moves_every_metric(where):
    base = stream()
    hit = stream(stall_at=where, stall_s=1.5)
    w0, w1 = 1.0, 19.0
    assert stats.tokens_per_s(hit, w0, w1) < stats.tokens_per_s(base, w0, w1)
    p95 = stats.percentile(stats.latencies_ms(base, w0, w1), 95)
    assert stats.percentile(stats.latencies_ms(hit, w0, w1), 95) > p95
    assert stats.on_time_share(hit, w0, w1) < \
        stats.on_time_share(base, w0, w1) == 100.0


def test_rate_counts_every_answered_request_of_the_window():
    recs = stream()
    for r in recs[::10]:
        r["merged"], r["outcome"] = True, "served"
    recs[101]["outcome"], recs[101]["done"] = None, None
    recs[102]["outcome"] = "dropped"
    w0, w1 = 1.0, 19.0
    # merged and result-cache answers count like the engine's; an
    # unanswered or dropped request and one answered outside count nothing
    # answered in [1, 19]: due from 0.8 to 18.8 s, requests 16 to 376,
    # less the two
    want = 110 * (376 - 16 + 1 - 2)
    assert stats.tokens_per_s(recs, w0, w1) == pytest.approx(want / 18.0)


def test_a_dropped_or_unanswered_request_is_a_miss():
    recs = stream(n=100)
    recs[40]["outcome"] = "dropped"
    recs[41]["outcome"], recs[41]["done"] = None, None
    share = stats.on_time_share(recs, 0.0, 5.0)
    assert share == pytest.approx(100.0 * 98 / 100)
    assert stats.resolved(recs[41], recs[41]["due"] + 0.5)
    assert not stats.resolved(recs[41], recs[41]["due"] + 0.1)
