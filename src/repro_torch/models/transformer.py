"""Block assembly: per-layer pattern → stacked period groups.

A port of ``repro.models.transformer`` with the same trees, so a
parameter or cache carried across from the JAX package is a leaf-for-leaf
copy. A model is ``first_k_dense`` unstacked leading blocks followed by
``n_repeats`` copies of a ``period``-long block group; the group's params
and caches are stacked over repeats, (R, …) per period position, and the
backbone loops over the repeats with views ``t[r]`` (the JAX version
scans). Caches are updated in place through those views.

    {"embed": {...}, "lead": [block, ...],
     "scan": [stacked_block_pos0, ...], "final_norm": {...}}
    block = {"norm1", "norm2", "attn", "mlp", ["post_norm1", "post_norm2"]}

The port serves dense attention models; Mamba, cross-attention and MoE
blocks raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.kvcache import init_kv_cache, layer_capacity

Params = Dict[str, Any]


def _unported(spec: BlockSpec) -> None:
    if spec.mixer == "mamba":
        raise NotImplementedError(
            "Mamba blocks are not ported yet (ROADMAP.md queue 1, slice 2, item 8)"
        )
    if spec.mixer == "xattn":
        raise NotImplementedError(
            "cross-attention blocks are not ported yet (ROADMAP.md queue 1, slice 2, "
            "item 8)"
        )
    if spec.moe:
        raise NotImplementedError(
            "MoE feed-forward blocks are not ported yet (ROADMAP.md queue 1, "
            "slice 2, item 8)"
        )


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure (dicts and lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}  # det: ok keyed
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees, strict=True))
    return fn(*trees)


def _stack(trees: List[Params]) -> Params:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def init_block(
    cfg: ModelConfig, spec: BlockSpec, gen: torch.Generator, device, lead: bool = False
) -> Params:
    _unported(spec)
    p: Params = {"norm1": L.init_norm(cfg, device), "norm2": L.init_norm(cfg, device)}
    p["attn"] = L.init_attention(cfg, gen, device)
    d_ff = (cfg.first_dense_d_ff or None) if lead else None
    p["mlp"] = L.init_mlp(cfg, gen, device, d_ff=d_ff)
    if cfg.sandwich_norm:
        p["post_norm1"] = L.init_norm(cfg, device)
        p["post_norm2"] = L.init_norm(cfg, device)
    return p


def apply_block(
    cfg: ModelConfig,
    spec: BlockSpec,
    p: Params,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    plain_attention: bool = False,
) -> torch.Tensor:
    """One block; its cache (if any) is updated in place."""
    _unported(spec)
    h = L.apply_norm(cfg, p["norm1"], x)
    y, _ = L.attention_block(
        cfg,
        p["attn"],
        h,
        positions=positions,
        local=(spec.mixer == "local"),
        cache=cache,
        plain_attention=plain_attention,
    )
    if cfg.sandwich_norm:
        y = L.apply_norm(cfg, p["post_norm1"], y)
    x = x + y
    h = L.apply_norm(cfg, p["norm2"], x)
    y = L.apply_mlp(cfg, p["mlp"], h)
    if cfg.sandwich_norm:
        y = L.apply_norm(cfg, p["post_norm2"], y)
    return x + y


# ---------------------------------------------------------------------------
# Backbone init
# ---------------------------------------------------------------------------


def init_backbone(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    lead = [
        init_block(cfg, cfg.block_spec(i), gen, device, lead=True)
        for i in range(cfg.first_k_dense)
    ]
    scan: List[Params] = []
    for spec in cfg.period_specs():
        per_repeat = [init_block(cfg, spec, gen, device) for _ in range(cfg.n_repeats)]
        scan.append(_stack(per_repeat))
    return {"lead": lead, "scan": scan}


# ---------------------------------------------------------------------------
# Cache init (mirrors backbone structure)
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device="cpu") -> Params:
    def one(spec: BlockSpec) -> Dict[str, torch.Tensor]:
        _unported(spec)
        cap = layer_capacity(cfg, spec.mixer == "local", max_seq)
        return init_kv_cache(cfg, batch, cap, device=device)

    lead = [one(cfg.block_spec(i)) for i in range(cfg.first_k_dense)]
    scan = []
    for spec in cfg.period_specs():
        per_repeat = [one(spec) for _ in range(cfg.n_repeats)]
        scan.append(_stack(per_repeat) if per_repeat else {})
    return {"lead": lead, "scan": scan}


# ---------------------------------------------------------------------------
# Backbone apply
# ---------------------------------------------------------------------------


def apply_backbone(
    cfg: ModelConfig,
    params: Params,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    caches: Optional[Params] = None,
    plain_attention: bool = False,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (hidden states, caches); the caches are updated in place."""
    for i in range(cfg.first_k_dense):
        c = caches["lead"][i] if caches is not None else None
        x = apply_block(
            cfg,
            cfg.block_spec(i),
            params["lead"][i],
            x,
            positions=positions,
            cache=c,
            plain_attention=plain_attention,
        )
    specs = cfg.period_specs()
    for r in range(cfg.n_repeats):
        for j, spec in enumerate(specs):
            block = tree_map(lambda t, r=r: t[r], params["scan"][j])
            c = None
            if caches is not None:
                c = tree_map(lambda t, r=r: t[r], caches["scan"][j])
            x = apply_block(
                cfg,
                spec,
                block,
                x,
                positions=positions,
                cache=c,
                plain_attention=plain_attention,
            )
    return x, caches
