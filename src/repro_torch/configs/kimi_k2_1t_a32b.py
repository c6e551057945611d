"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) vocab=163840;
MoE 384 experts top-8 (+1 shared), expert d_ff=2048, first layer dense —
trillion-parameter MoE (paper-table scale).  [arXiv:2501.kimi2; unverified]

Memory notes (DESIGN.md §5, reported honestly in EXPERIMENTS.md §Dry-run):
~1.03 T total params. Master params are kept bf16 and expert fan-ins shard
FSDP-style over the data axis on top of 16-way EP — pure TP-sharded fp32
masters (253 GB/chip) cannot fit a 16 GB v5e. Optimizer must be factored
or 8-bit (repro.train.optimizer supports both).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,                # assignment-table d_ff (= expert hidden dim)
    vocab_size=163840,
    n_experts=384,
    n_experts_per_tok=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    moe_period=1,
    moe_offset=0,
    first_k_dense=1,
    first_dense_d_ff=18432,   # the single dense layer (paper-reported width)
    rope_theta=50000.0,
    param_dtype="bfloat16",   # memory: see module docstring
)

SMOKE = ModelConfig(
    name="kimi-k2-1t-a32b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    n_experts=8,
    n_experts_per_tok=2,
    n_shared_experts=1,
    moe_d_ff=32,
    moe_period=1,
    moe_offset=0,
    first_k_dense=1,
    first_dense_d_ff=128,
    dtype="float32",
)
