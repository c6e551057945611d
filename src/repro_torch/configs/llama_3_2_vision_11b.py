"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers (every 5th layer).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Frontend STUB (per assignment): the ViT tower is not built — cross-attn
layers consume precomputed patch embeddings (B, 1600, d_model) supplied by
repro.models.frontends.fake_patch_embeddings / launch.dryrun.input_specs.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5,
    n_vision_tokens=1600,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke",
    family="vlm",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=176,
    vocab_size=512,
    cross_attn_period=5,
    n_vision_tokens=16,
    dtype="float32",
)
