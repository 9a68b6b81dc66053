"""chunk_pad_share: the share of the window's chunked-prefill launch cells
(rows x keys; every launch is padded to the step token budget in rows and
to the arena's capacity plus that budget in keys) that hold no real row
and attended key (engine counters chunk_cells and chunk_cells_launched),
in percent.  Moves tokens_per_s."""


def read(ctx):
    a, b = ctx["stats0"], ctx["stats1"]
    if "chunk_cells_launched" not in b:
        return None
    launched = b["chunk_cells_launched"] - a["chunk_cells_launched"]
    if launched <= 0:
        return None
    return 100.0 * (1.0 - (b["chunk_cells"] - a["chunk_cells"]) / launched)
