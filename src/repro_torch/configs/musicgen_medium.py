"""musicgen-medium [audio] — 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Frontend STUB (per assignment): the EnCodec tokenizer is not built — the
backbone consumes codec token ids directly
(repro.models.frontends.fake_codec_tokens / launch.dryrun.input_specs).
Positional encoding: RoPE stands in for the original sinusoidal embedding
(backbone-only scope; noted in DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    norm="layernorm",
    use_bias=True,
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    family="audio",
    n_layers=2,
    d_model=48,
    n_heads=6,            # 6 heads: not divisible by smoke TP either —
    n_kv_heads=6,         # exercises the heads-replication fallback
    head_dim=8,
    d_ff=192,
    vocab_size=256,
    act="gelu",
    norm="layernorm",
    use_bias=True,
    dtype="float32",
)
