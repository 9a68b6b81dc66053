"""mla_expand_ratio: latent tokens the window's chunked prefills
decompressed into per-head keys and values (engine counter
mla_expand_tokens: each chunk's prefix and its real rows) over the real
chunk rows (chunk_rows), in tokens a row: how often the prefill decompresses
a prompt's latent again.  Moves tokens_per_s."""


def read(ctx):
    a, b = ctx["stats0"], ctx["stats1"]
    if "mla_expand_tokens" not in b:
        return None
    rows = b["chunk_rows"] - a["chunk_rows"]
    if rows <= 0:
        return None
    return (b["mla_expand_tokens"] - a["mla_expand_tokens"]) / rows
