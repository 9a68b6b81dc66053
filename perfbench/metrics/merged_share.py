"""merged_share: requests answered by a merge or by the result cache over
the requests completed in the window (control-plane and engine counters
merges, cache_hits, completed), in percent.  Moves tokens_per_s."""


def read(ctx):
    a, b = ctx["stats0"], ctx["stats1"]
    done = b["completed"] - a["completed"]
    if done <= 0:
        return None
    shared = (b["merges"] - a["merges"]) + (b["cache_hits"] - a["cache_hits"])
    return 100.0 * shared / done
