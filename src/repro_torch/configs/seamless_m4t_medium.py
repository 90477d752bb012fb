"""seamless-m4t-medium — encoder-decoder multimodal backbone.

[arXiv:2308.11596; hf]  Backbone only: the speech frontend is a stub;
``input_specs()`` provides precomputed frame embeddings for the encoder.
12L encoder + 12L decoder, MHA, d_ff 4096.  RoPE replaces the original
relative positions (TPU-adaptation note in DESIGN.md).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    norm_type="layernorm",
    act="gelu",
    encdec=True,
    n_encoder_layers=12,
    frontend="audio",
    frontend_tokens=0,
    rope_theta=10000.0,
    source="arXiv:2308.11596; hf",
)
