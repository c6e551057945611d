"""Modality frontend stubs: precomputed inputs for the audio and VLM archs.

A copy of ``repro.models.frontends`` (numpy only; the port may not import
the JAX package). The ``[audio]`` and ``[vlm]`` archs specify the
transformer backbone only; the frontend supplies its inputs:

  * musicgen-medium: the EnCodec tokenizer is stubbed, and the backbone
    consumes codec token ids (vocab 2048) directly;
  * llama-3.2-vision-11b: the ViT tower is stubbed, and the
    cross-attention layers consume precomputed patch embeddings
    (B, n_vision_tokens, d_model).

Same seeds, same values as the reference (``tests/test_torch_blocks.py``
holds them bit-equal).
"""

from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


def fake_codec_tokens(cfg: ModelConfig, batch: int, seq: int, seed: int = 0) -> np.ndarray:
    """Deterministic EnCodec-like token stream (audio stub)."""
    rng = np.random.default_rng(seed)
    # codec streams are locally smooth: random walk over the codebook
    steps = rng.integers(-3, 4, size=(batch, seq))
    toks = np.cumsum(steps, axis=1) % (cfg.vocab_size - 2) + 2
    return toks.astype(np.int32)


def fake_patch_embeddings(cfg: ModelConfig, batch: int, seed: int = 0) -> np.ndarray:
    """Deterministic ViT-output stand-in (vision stub): (B, Nv, d_model)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.02, size=(batch, cfg.n_vision_tokens, cfg.d_model))
    return x.astype(np.float32)
