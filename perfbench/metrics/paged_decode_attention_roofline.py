"""paged_decode_attention_roofline: the least time the traced span's
paged decode attention launches could take on the card (the larger of
their bytes over the HBM peak and their FLOPs over the bf16 peak, counted
from each launch's real lengths: q in, out, each attended key's K and V
read once, tables and lengths) over the kernel's device time in the
trace, in percent.  Moves tokens_per_s."""

from perfbench import stats


def read(ctx):
    return stats.kernel_roofline(ctx, "paged_decode_attention")
