"""qwen3-moe-30b-a3b — 128 experts top-8, qk-norm GQA.

[hf:Qwen/Qwen3-30B-A3B; hf]  head_dim=128 decoupled from d_model/n_heads (as
in the HF config); every layer is MoE with expert d_ff (moe_intermediate
size) 768.
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    norm_type="rmsnorm",
    act="swiglu",
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768),
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
