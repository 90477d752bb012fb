"""internvl2-1b — VLM backbone (Qwen2-0.5B-like).  [arXiv:2404.16821; hf]

Backbone only per the assignment: the InternViT frontend is a stub;
``input_specs()`` provides precomputed patch embeddings that fill the first
``frontend_tokens`` positions of the sequence.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    norm_type="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
    frontend="vision",
    frontend_tokens=256,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821; hf",
)
