"""xlstm-125m — sLSTM + mLSTM blocks.  [arXiv:2405.04517; unverified]

d_ff=0 per the assignment: projections live inside the xLSTM blocks.  We use
a 6-layer period with one sLSTM block (positions chosen to divide the 12
layers evenly); recurrent state is O(1) per token, so long_500k runs.
"""

from .base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    norm_type="layernorm",
    act="swiglu",
    tie_embeddings=True,
    layer_pattern="llllls",
    xlstm=XLSTMConfig(),
    source="arXiv:2405.04517; unverified",
)
