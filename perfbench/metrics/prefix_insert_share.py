"""prefix_insert_share: the host seconds the unit runner spent in the
prefix cache's inserts at completion, less the prompt downloads inside
them, over the window's seconds (engine counters kv_insert_wall_s and
kv_download_wall_s), in percent.  Moves tokens_per_s."""


def read(ctx):
    a, b = ctx["stats0"], ctx["stats1"]
    if "kv_insert_wall_s" not in b:
        return None
    insert = b["kv_insert_wall_s"] - a["kv_insert_wall_s"]
    download = b["kv_download_wall_s"] - a["kv_download_wall_s"]
    return 100.0 * (insert - download) / ctx["window_s"]
