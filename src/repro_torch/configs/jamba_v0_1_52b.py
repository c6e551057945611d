"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; Mamba+attention 1:7 interleave (attention at index 4 of each
8-layer period), MoE 16 experts top-2 every other layer. No positional
encoding on attention (Mamba carries position).  [arXiv:2403.19887; hf]
"""

from repro_torch.models.config import ModelConfig

_PERIOD = ("mamba", "mamba", "mamba", "mamba",
           "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=_PERIOD,
    rotary_pct=0.0,           # jamba attention is NoPE
    n_experts=16,
    n_experts_per_tok=2,
    moe_period=2,
    moe_offset=1,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    layer_pattern=_PERIOD,
    rotary_pct=0.0,
    n_experts=4,
    n_experts_per_tok=2,
    moe_period=2,
    moe_offset=1,
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=16,
    dtype="float32",
)
