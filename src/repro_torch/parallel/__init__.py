"""Parallelism and analysis of the port (``repro.parallel`` counterparts):
sharding rules as DTensor placements, the activation-sharding context,
int8 compressed all-reduce and the GPipe pipeline over ``torch.distributed``,
and the per-rank op counter and roofline with H100 constants."""
