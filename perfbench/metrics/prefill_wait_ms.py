"""prefill_wait_ms: the mean wait from a request's admission to the unit to
its first token (the engine's Request.t_admit and t_first, copied into
each record as admit and first) over the requests whose first token fell
in the window, in milliseconds; nothing where the records carry no
stamps.  Moves tokens_per_s."""


def read(ctx):
    w = [r["first"] - r["admit"] for r in ctx["records"]
         if r.get("first") is not None
         and ctx["w0"] <= r["first"] <= ctx["w1"]]
    if not w:
        return None
    return 1e3 * sum(w) / len(w)
