"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16; Mamba-1 architecture (d_inner 8192, conv 4, no FF half).
[arXiv:2410.05355; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,              # unused (attention-free)
    d_ff=0,                   # Mamba-1 block has no FF half
    vocab_size=65024,
    layer_pattern=("mamba",),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=16,
    d_ff=0,
    vocab_size=512,
    layer_pattern=("mamba",),
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=16,
    dtype="float32",
)
