"""latency_p50_ms: the median of the due-to-answer wall times of every
request the Router answered in the window, in milliseconds.  Moves
latency_p90_ms."""

from perfbench import stats


def read(ctx):
    lat = stats.latencies_ms(ctx["records"], ctx["w0"], ctx["w1"])
    return stats.percentile(lat, 50) if lat else None
