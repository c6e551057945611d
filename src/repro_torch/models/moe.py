"""Mixture-of-Experts feed-forward (mixtral / kimi-k2 / jamba).

A port of ``repro.models.moe``, single device. Token-choice top-k routing
with capacity-bounded scatter dispatch:

  1. router logits → top-k experts per token (+ renormalised weights);
  2. each (token, choice) gets a slot inside its expert's capacity via a
     cumulative-sum position in token-major order (tokens beyond capacity
     are dropped: the GShard/Switch discipline, capacity_factor-controlled);
  3. tokens are scattered into a dense (E, cap, d) buffer, the experts run
     as three batched products over all experts, and the results gather
     back.

The reference computes all of this outside any Pallas kernel, so the
expert products are plain batched matmuls here too. Aux losses: the
switch load-balancing loss and the router z-loss, returned for a trainer
to weigh in, and the fraction of dropped (token, choice) pairs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    std = 1.0 / math.sqrt(d)
    p: Params = {
        "router": L._normal(cfg, (d, e), std, gen, device),
        "wi": L._normal(cfg, (e, d, f), std, gen, device),
        "wg": L._normal(cfg, (e, d, f), std, gen, device),
        "wo": L._normal(cfg, (e, f, d), std / math.sqrt(2 * cfg.n_layers), gen, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(cfg, gen, device, d_ff=cfg.n_shared_experts * f)
    return p


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(n_tokens * cfg.n_experts_per_tok / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to a lane-friendly multiple


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities per row and their experts, ties to the
    lower expert index (``jax.lax.top_k``'s order; ``torch.topk`` on CUDA
    promises none)."""
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return weights[:, :k], ids[:, :k]


def _dropped_frac(keep: torch.Tensor) -> torch.Tensor:
    """``1 - keep.mean()`` in float32 as compiled XLA computes the
    reference's: the mean's division becomes a product with the float32
    reciprocal of the count, fused with the subtraction (rounded once),
    so the port's fraction equals the reference's bit for bit."""
    recip = float(torch.tensor(1.0 / keep.numel(), dtype=torch.float32))
    return (1.0 - keep.sum().double() * recip).float()


def apply_moe(
    cfg: ModelConfig, p: Params, x: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The single-device formulation; the reference's shard-local path
    waits for the distributed port (:func:`apply_moe_shard_map`)."""
    return apply_moe_spmd(cfg, p, x)


def apply_moe_spmd(
    cfg: ModelConfig, p: Params, x: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) → (y, aux). aux: {"aux_loss", "z_loss", "dropped_frac"}."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    t = b * s
    cap = _capacity(cfg, t)
    dt = x.dtype
    xf = x.reshape(t, d)

    # -- routing (f32 for numerics) ---------------------------------------------
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    weights, ids = _top_k(probs, k)  # (T, k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)

    # -- aux losses ---------------------------------------------------------------
    onehot = F.one_hot(ids, e).float()  # (T, k, E)
    tokens_per_expert = onehot.sum((0, 1)) / t  # f_e
    mean_prob = probs.mean(0)  # P_e
    aux_loss = e * torch.sum(tokens_per_expert * mean_prob)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # -- slot assignment (token-major priority, GShard discipline) --------------
    ohf = onehot.reshape(t * k, e).to(torch.int64)
    slot = (torch.cumsum(ohf, dim=0) * ohf).sum(-1) - 1
    expert = ids.reshape(t * k)
    keep = (slot >= 0) & (slot < cap)
    slot_c = slot.clamp(0, cap - 1)
    dropped = _dropped_frac(keep)

    # -- scatter → expert products → gather ---------------------------------------
    contrib = xf.repeat_interleave(k, dim=0) * keep[:, None].to(dt)  # (T*k, d)
    buf = torch.zeros((e, cap, d), dtype=dt, device=x.device)
    buf.index_put_((expert, slot_c), contrib, accumulate=True)

    h = L._act(cfg, torch.bmm(buf, p["wg"].to(dt))) * torch.bmm(buf, p["wi"].to(dt))
    y_buf = torch.bmm(h, p["wo"].to(dt))  # (E, cap, d)

    y_tok = y_buf[expert, slot_c] * keep[:, None].to(dt)  # (T*k, d)
    w_flat = weights.reshape(t * k).to(dt)
    y = (y_tok * w_flat[:, None]).reshape(t, k, d).sum(1)

    if cfg.n_shared_experts:
        y = y + L.apply_mlp(cfg, p["shared"], xf)

    aux = {"aux_loss": aux_loss.float(), "z_loss": z_loss.float(), "dropped_frac": dropped}
    return y.reshape(b, s, d), aux


def apply_moe_shard_map(cfg: ModelConfig, p: Params, x: torch.Tensor, rules: Any):
    """The reference's shard-local expert-parallel dispatch
    (``repro.models.moe.apply_moe_shard_map``) needs the distributed port."""
    raise NotImplementedError(
        "shard-local MoE dispatch is not ported yet: it waits for torch.distributed "
        "sharding (ROADMAP.md queue 1, item 16)"
    )
