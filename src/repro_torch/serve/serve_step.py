"""Prefill / decode step builders (port of ``repro.serve.serve_step``).

MoE capacity is widened at serve time (no-drop style) via
``serve_config``, as in the reference: capacity drops are a
training-throughput trade, not something to serve users with.
"""

from __future__ import annotations

import dataclasses
import torch

from repro_torch.models import model as model_lib
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def serve_config(cfg: ModelConfig, capacity_factor: float = 4.0) -> ModelConfig:
    if cfg.n_experts and cfg.capacity_factor < capacity_factor:
        return dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def build_prefill_step(
    cfg: ModelConfig, capacity_factor: float = 4.0, plain_attention: bool = False
):
    scfg = serve_config(cfg, capacity_factor)

    def prefill_step(params, tokens, caches, vision=None):
        return model_lib.prefill(
            scfg, params, tokens, caches, vision=vision, plain_attention=plain_attention
        )

    return prefill_step


def build_decode_step(
    cfg: ModelConfig, capacity_factor: float = 4.0, plain_attention: bool = False
):
    """Greedy decoding: the next token is the argmax of the logits."""
    scfg = serve_config(cfg, capacity_factor)

    def decode_step(params, token, pos, caches, vision=None):
        logits, caches = model_lib.decode_step(
            scfg, params, token, pos, caches, vision=vision, plain_attention=plain_attention
        )
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, caches

    return decode_step


def init_serve_caches(cfg: ModelConfig, batch: int, max_seq: int, device="cpu"):
    return T.init_caches(cfg, batch, max_seq, device=device)
