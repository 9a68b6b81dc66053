"""control_plane_share: the self time of the Router's and the control
plane's spans (router.*, cp.*: the event loop, merge detection, mapping,
pruning) over the window, in percent.  Reads the program's span totals at
the window's two ends (spans0, spans1: obs.Telemetry.span_totals()), and
nothing where the run attached no Telemetry.  Moves tokens_per_s."""


def read(ctx):
    a, b = ctx.get("spans0"), ctx.get("spans1")
    if a is None or b is None:
        return None
    names = [k for k in b if k.startswith(("router.", "cp."))]
    if not names:
        return None
    s = sum(b[k]["span_self_s"] - a.get(k, {}).get("span_self_s", 0.0)
            for k in names)
    return 100.0 * s / (ctx["w1"] - ctx["w0"])
