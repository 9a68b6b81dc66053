"""xlstm-125m [ssm]: 12 blocks d_model=768 4H vocab=50304, alternating
mLSTM (matrix-memory, parallelizable) and sLSTM (scalar-memory, gated
recurrence) blocks at 1:1 [arXiv:2405.04517].

d_ff=0 per the assignment: blocks are gated projection blocks (the xLSTM
up/down projections), no separate FFN.  Fully recurrent: O(1) state per
step, eligible for long_500k.
"""

from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm=XLSTMConfig(pattern=("mlstm", "slstm"), proj_factor=2.0),
    subquadratic=True,
)
