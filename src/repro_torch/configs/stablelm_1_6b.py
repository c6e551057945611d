"""stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32) d_ff=5632
vocab=100352; partial rotary (25 %), LayerNorm, qkv bias.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    norm="layernorm",
    use_bias=True,
    rotary_pct=0.25,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="stablelm-1.6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=176,
    vocab_size=512,
    norm="layernorm",
    use_bias=True,
    rotary_pct=0.25,
    dtype="float32",
)
