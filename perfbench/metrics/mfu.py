"""mfu: FLOPs of the window's real prompt and decode tokens (counted from
the config by the family module, no pad rows or keys) over the window and
the card's bf16 peak, in percent.  Moves tokens_per_s."""


def read(ctx):
    peak = (ctx["peaks"] or {}).get("bf16_flops_per_s")
    steps = [s for s in ctx["steps"] if ctx["w0"] <= s["t0"]
             and s["t1"] <= ctx["w1"]]
    if peak is None or not steps:
        return None
    return 100.0 * sum(s["flops"] for s in steps) / (ctx["window_s"] * peak)
