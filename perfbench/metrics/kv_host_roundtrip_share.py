"""kv_host_roundtrip_share: the self time of the unit runner's K/V round
trip through the host (runner.kv_in: earlier chunks' K/V concatenated and
uploaded, and the commit into the pages; runner.kv_out: a chunk's K/V
copied to the host) over the window, in percent.  Reads the program's
span totals at the window's two ends (spans0, spans1), and nothing where
the run attached no Telemetry.  Moves tokens_per_s."""

SPANS = ("runner.kv_in", "runner.kv_out")


def read(ctx):
    a, b = ctx.get("spans0"), ctx.get("spans1")
    if a is None or b is None or not any(k in b for k in SPANS):
        return None
    s = sum(b[k]["span_self_s"] - a.get(k, {}).get("span_self_s", 0.0)
            for k in SPANS if k in b)
    return 100.0 * s / (ctx["w1"] - ctx["w0"])
