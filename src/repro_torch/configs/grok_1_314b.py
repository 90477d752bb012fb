"""grok-1-314b — 8 experts top-2 MoE.  [hf:xai-org/grok-1; unverified]"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    norm_type="rmsnorm",
    act="gelu",
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32768),
    rope_theta=10000.0,
    source="hf:xai-org/grok-1; unverified",
)
