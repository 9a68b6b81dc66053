"""decode_occupancy: the real rows of the window's batched paged-decode
launches over the rows launched (each launch is padded to the unit's
max_batch; engine counters decode_rows and decode_launches), in percent.
Moves tokens_per_s."""


def read(ctx):
    a, b = ctx["stats0"], ctx["stats1"]
    if "decode_launches" not in b:
        return None
    launches = b["decode_launches"] - a["decode_launches"]
    if launches <= 0:
        return None
    rows = b["decode_rows"] - a["decode_rows"]
    return 100.0 * rows / (launches * ctx["unit"]["max_batch"])
