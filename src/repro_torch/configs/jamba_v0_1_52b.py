"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  Attention every 8th layer (offset 4, as in the HF
release: attn_layer_period=8, attn_layer_offset=4); MoE on every other layer
(expert_layer_period=2, offset=1).  Sub-quadratic (runs long_500k): only 4 of
32 layers attend; Mamba state is O(1) per token.
"""

from .base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    norm_type="rmsnorm",
    act="swiglu",
    layer_pattern="MMMMAMMM",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=14336, period=2, offset=1),
    rope_theta=10000.0,
    source="arXiv:2403.19887; hf",
)
