"""dropped_share: requests due in the window that the pruner or the
control plane dropped, over the requests due in it, in percent.  Moves
on_time_share."""

from perfbench import stats


def read(ctx):
    due = stats.due_in(ctx["records"], ctx["w0"], ctx["w1"])
    if not due:
        return None
    return 100.0 * sum(r["outcome"] == "dropped" for r in due) / len(due)
