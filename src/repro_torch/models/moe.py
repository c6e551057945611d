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

Under sharding rules that ask for it (``moe_shard_map``),
:func:`apply_moe_shard_map` routes each data shard's tokens into a buffer
for the experts its "model" rank holds (EP) or for its slice of the
expert FF (ff-TP), and sums the partial outputs with one all-reduce over
"model".
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed.compat import shard_map
from repro_torch.distributed.sharding import P, constrain, current_rules
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
    """Dispatch to the shard-local implementation when sharding rules are
    active and request it, else the single-device formulation."""
    rules = current_rules()
    if rules is not None and rules.options.get("moe_shard_map"):
        return apply_moe_shard_map(cfg, p, x, rules)
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

    weights, expert, slot, keep, aux = _route(cfg, xf, p["router"], cap)
    slot_c = slot.clamp(0, cap - 1)

    # -- scatter → expert products → gather ---------------------------------------
    contrib = xf.repeat_interleave(k, dim=0) * keep[:, None].to(dt)  # (T*k, d)
    buf = torch.zeros((e, cap, d), dtype=dt, device=x.device)
    buf.index_put_((expert, slot_c), contrib, accumulate=True)
    buf = constrain(buf, "expert", "moe_cap", None)

    h = L._act(cfg, torch.bmm(buf, p["wg"].to(dt))) * torch.bmm(buf, p["wi"].to(dt))
    y_buf = torch.bmm(h, p["wo"].to(dt))  # (E, cap, d)
    y_buf = constrain(y_buf, "expert", "moe_cap", None)

    y_tok = y_buf[expert, slot_c] * keep[:, None].to(dt)  # (T*k, d)
    w_flat = weights.reshape(t * k).to(dt)
    y = (y_tok * w_flat[:, None]).reshape(t, k, d).sum(1)

    if cfg.n_shared_experts:
        y = y + L.apply_mlp(cfg, p["shared"], xf)
    return y.reshape(b, s, d), aux


def _route(cfg: ModelConfig, xf: torch.Tensor, router: torch.Tensor, cap: int):
    """Routing, aux losses and slot assignment of the (T, d) tokens ``xf``:
    (weights (T, k), expert (T*k,), slot (T*k,), keep (T*k,), aux)."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.n_experts_per_tok

    # -- routing (f32 for numerics) ---------------------------------------------
    logits = xf.float() @ router.float()
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
    aux = {"aux_loss": aux_loss.float(), "z_loss": z_loss.float(), "dropped_frac": _dropped_frac(keep)}
    return weights, expert, slot, keep, aux


def apply_moe_shard_map(
    cfg: ModelConfig, p: Params, x: torch.Tensor, rules: Any
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Shard-local MoE: route/scatter/compute per data shard; combine
    expert-parallel partial outputs with ONE all-reduce over "model".

    Every data shard routes only its tokens into a buffer for the experts
    its model rank owns (EP: ``expert`` on "model", each rank holds E/n
    experts and masks the tokens routed elsewhere) or for a slice of the
    expert FF (ff-TP fallback); either way the only inter-rank traffic is
    the activation-sized sum of partial outputs over "model". Capacity is
    per data shard (``T_local``-based), and the aux terms are averaged
    over the data axes so they equal the global-batch formulation.

    Plain tensors are the rank's blocks: ``x`` its data shard's tokens,
    ``wi``/``wg``/``wo`` its experts (EP) or its FF slice (ff-TP); DTensors
    are brought to those layouts (``compat.shard_map``). Gradients follow
    the SPMD rule of ``collectives``: with a loss replicated over "model",
    each rank's weight gradients are its data shard's, and a sum over the
    data axes gives the global-batch gradient.
    """
    names = tuple(rules.mesh.mesh_dim_names)
    tp_axis = "model" if "model" in names else None
    d = x.shape[-1]

    x_spec = rules.spec(("batch", None, None), x.shape)
    # a plain x is the rank's block of a batch sharded over every batch
    # axis; where the batch is in fact replicated on some of them, their
    # ranks hold equal aux terms, whose mean is the same
    dp_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
    ep = rules.rules.get("expert") == tp_axis and tp_axis is not None
    ff_tp = (
        not ep and tp_axis is not None and cfg.expert_d_ff % rules.axis_size.get(tp_axis, 1) == 0
    )
    # weight in_specs: EP slices experts; the TP fallback slices expert-ff
    if ep:
        wi_spec = wo_spec = P(tp_axis, None, None)
    elif ff_tp:
        wi_spec, wo_spec = P(None, None, tp_axis), P(None, tp_axis, None)
    else:
        wi_spec = wo_spec = P()

    def body(x_l, router, wi, wg, wo, shared):
        bl, sl, _ = x_l.shape
        t = bl * sl
        xf = x_l.reshape(t, d)
        dt = x_l.dtype
        k = cfg.n_experts_per_tok
        cap = _capacity(cfg, t)
        weights, expert, slot, keep, aux = _route(cfg, xf, router, cap)

        e_loc = wi.shape[0]
        if ep:
            e_start = C.axis_index(tp_axis) * e_loc
            local = (expert >= e_start) & (expert < e_start + e_loc)
            keep_l = keep & local
            expert_l = (expert - e_start).clamp(0, e_loc - 1)
        else:
            keep_l = keep
            expert_l = expert
        slot_c = slot.clamp(0, cap - 1)
        w_flat = weights.reshape(t * k).to(dt)
        xe = xf
        if tp_axis is not None:
            # each model rank uses its own part of these replicated values
            xe, w_flat = C.pvary(xf, tp_axis), C.pvary(w_flat, tp_axis)
        contrib = xe.repeat_interleave(k, dim=0) * keep_l[:, None].to(dt)
        buf = torch.zeros((e_loc, cap, d), dtype=dt, device=x_l.device)
        buf = buf.index_put((expert_l, slot_c), contrib, accumulate=True)

        h = L._act(cfg, torch.bmm(buf, wg.to(dt))) * torch.bmm(buf, wi.to(dt))
        y_buf = torch.bmm(h, wo.to(dt))
        y_tok = y_buf[expert_l, slot_c] * keep_l[:, None].to(dt)
        y = (y_tok * w_flat[:, None]).reshape(t, k, d).sum(1)
        if tp_axis is not None:
            y = C.psum(y, tp_axis)  # combine EP / ff-TP partials
        if shared is not None:
            y = y + L.apply_mlp(cfg, shared, xf)
        if dp_axes:
            # router stats are token-local → average across data shards so
            # the aux losses equal the global-batch formulation
            aux = {name: C.pmean(v, dp_axes) for name, v in sorted(aux.items())}
        return y.reshape(bl, sl, d), aux

    return shard_map(
        body,
        rules.mesh,
        in_specs=(x_spec, P(), wi_spec, wi_spec, wo_spec, None),
        out_specs=(x_spec, {name: P() for name in ("aux_loss", "z_loss", "dropped_frac")}),
    )(x, p["router"], p["wi"], p["wg"], p["wo"], p.get("shared"))
