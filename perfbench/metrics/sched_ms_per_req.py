"""sched_ms_per_req: the control plane's scheduling wall in the window
(mapping_wall_s, which holds the pruner's pruning_wall_s) over the
requests submitted in it, in milliseconds.  Moves latency_p90_ms."""


def read(ctx):
    if ctx["submitted"] <= 0:
        return None
    wall = ctx["stats1"]["mapping_wall_s"] - ctx["stats0"]["mapping_wall_s"]
    return 1e3 * wall / ctx["submitted"]
