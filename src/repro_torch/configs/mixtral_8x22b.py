"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768; 8 experts top-2, sliding-window attention (4096, per the
assignment table).  [arXiv:2401.04088; hf]

Sharding note (DESIGN.md §5): 8 experts < TP=16 → experts replicate and
the expert d_ff (16384) TP-shards instead — the divisibility-fallback path.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    layer_pattern=("local",),
    sliding_window=4096,
    n_experts=8,
    n_experts_per_tok=2,
    moe_period=1,
    moe_offset=0,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    layer_pattern=("local",),
    sliding_window=8,
    n_experts=4,
    n_experts_per_tok=2,
    moe_period=1,
    moe_offset=0,
    dtype="float32",
)
