"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; local+global alternating attention (window 4096), logit
softcaps (attn 50, final 30), sandwich norms, tied + scaled embeddings,
head_dim 256.  [arXiv:2408.00118; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    act="gelu",
    layer_pattern=("local", "attn"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sandwich_norm=True,
    scale_embeddings=True,
    tie_embeddings=True,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="gemma2-9b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    act="gelu",
    layer_pattern=("local", "attn"),
    sliding_window=8,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sandwich_norm=True,
    scale_embeddings=True,
    tie_embeddings=True,
    dtype="float32",
)
