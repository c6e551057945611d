"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000; GQA, no-bias, LayerNorm, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    use_bias=False,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)

SMOKE = ModelConfig(
    name="command-r-35b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=176,
    vocab_size=512,
    norm="layernorm",
    use_bias=False,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    dtype="float32",
)
