"""queue_wait_ms: the mean wait from a request's due time to its admission
to the unit (the engine's Request.t_admit, copied into each record as
admit) over the requests admitted in the window, in milliseconds; nothing
where the records carry no stamps.  Moves tokens_per_s."""


def read(ctx):
    w = [r["admit"] - r["due"] for r in ctx["records"]
         if r.get("admit") is not None
         and ctx["w0"] <= r["admit"] <= ctx["w1"]]
    if not w:
        return None
    return 1e3 * sum(w) / len(w)
