"""chunk_prefill_ms: the mean wall of the window's chunked-prefill step
launches (dispatch plus the wait for the card), in milliseconds.  Moves
tokens_per_s."""


def read(ctx):
    s = [x for x in ctx["steps"] if x["name"] == "chunk_prefill"
         and ctx["w0"] <= x["t0"] and x["t1"] <= ctx["w1"]]
    if not s:
        return None
    return 1e3 * sum(x["dispatch_s"] + x["execute_s"] for x in s) / len(s)
