"""prefix_reuse_share: prompt tokens the prefix cache supplied over the
prompt tokens admitted to the unit in the window (engine counters
prefix_tokens_reused and prefill_tokens), in percent.  Moves
tokens_per_s."""


def read(ctx):
    a, b = ctx["stats0"], ctx["stats1"]
    reused = b.get("prefix_tokens_reused", 0) - a.get("prefix_tokens_reused", 0)
    admitted = reused + b["prefill_tokens"] - a["prefill_tokens"]
    if admitted <= 0:
        return None
    return 100.0 * reused / admitted
