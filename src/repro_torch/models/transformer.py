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
    block = {"norm1", ["norm2"], ("attn"|"mamba"|"xattn"), ["mlp"|"moe"],
             ["post_norm1", "post_norm2"]}

A Mamba block's cache is its SSM state ``{"h", "conv"}``, written back in
place like the KV cache; a cross-attention block's is ``{}``.

``remat=True`` (training) runs each scanned block under
``torch.utils.checkpoint``: the backward pass recomputes the block from
its input and saves nothing inside it, the reference's
``jax.checkpoint(body, policy=nothing_saveable)`` over its scan body.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain, current_rules, sharded_extent
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.kvcache import init_kv_cache, layer_capacity

Params = Dict[str, Any]


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
# Aux losses of the MoE blocks
# ---------------------------------------------------------------------------

AUX_KEYS = ("aux_loss", "z_loss", "dropped_frac")


def _zero_aux(device="cpu") -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


def _add_aux(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if not b:
        return a
    return {k: a[k] + b.get(k, 0.0) for k in AUX_KEYS}


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def init_block(
    cfg: ModelConfig, spec: BlockSpec, gen: torch.Generator, device, lead: bool = False
) -> Params:
    p: Params = {"norm1": L.init_norm(cfg, device), "norm2": L.init_norm(cfg, device)}
    if spec.mixer == "mamba":
        p["mamba"] = ssm_lib.init_mamba(cfg, gen, device)
    elif spec.mixer == "xattn":
        p["xattn"] = L.init_attention(cfg, gen, device)
    else:
        p["attn"] = L.init_attention(cfg, gen, device)
    if spec.moe:
        p["moe"] = moe_lib.init_moe(cfg, gen, device)
    elif cfg.d_ff > 0:
        d_ff = (cfg.first_dense_d_ff or None) if lead else None
        p["mlp"] = L.init_mlp(cfg, gen, device, d_ff=d_ff)
    else:
        # pure Mamba-1 archs (falcon-mamba): the mixer IS the layer, no FF
        del p["norm2"]
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
    vision: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    plain_attention: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block → (x, aux). Its cache, if any, is updated in place; an
    empty cache ``{}`` is a stateless pass, as in the reference."""
    h = L.apply_norm(cfg, p["norm1"], x)
    state = cache if cache else None
    if spec.mixer == "mamba":
        y, new = ssm_lib.apply_mamba(cfg, p["mamba"], h, state=state)
        if state is not None:
            state["h"].copy_(new["h"])
            state["conv"].copy_(new["conv"])
    elif spec.mixer == "xattn":
        if vision is None:
            raise ValueError("xattn block needs vision embeddings")
        y, _ = L.attention_block(
            cfg, p["xattn"], h, positions=positions, local=False, kv_x=vision
        )
    else:
        y, _ = L.attention_block(
            cfg,
            p["attn"],
            h,
            positions=positions,
            local=(spec.mixer == "local"),
            cache=state,
            plain_attention=plain_attention,
        )
    if cfg.sandwich_norm:
        y = L.apply_norm(cfg, p["post_norm1"], y)
    x = x + y
    x = constrain(x, "batch", "seq", None)

    if "norm2" not in p:  # FF-less block (pure Mamba-1 layer)
        return x, {}
    h = L.apply_norm(cfg, p["norm2"], x)
    if spec.moe:
        y, aux = moe_lib.apply_moe(cfg, p["moe"], h)
    else:
        y, aux = L.apply_mlp(cfg, p["mlp"], h), {}
    if cfg.sandwich_norm:
        y = L.apply_norm(cfg, p["post_norm2"], y)
    x = x + y
    x = constrain(x, "batch", "seq", None)
    return x, aux


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
    """KV caches for attention blocks, SSM state for Mamba blocks, ``{}``
    for cross-attention blocks (their keys come from the vision input).

    Under sharding rules (``repro_torch.distributed``) ``batch`` and the
    capacities are global and each rank allocates its block: the batch
    over the rules' batch axes and, with ``cache_cap`` on "model", the
    KV capacity over "model"; both must divide evenly."""
    rules = current_rules()
    n_batch = sharded_extent(rules, "batch") if rules is not None else 1
    n_cap = sharded_extent(rules, "cache_cap") if rules is not None else 1
    if batch % n_batch:
        raise ValueError(f"batch {batch} does not divide over the {n_batch} batch blocks")
    batch //= n_batch

    def capacity(spec: BlockSpec) -> int:
        cap = layer_capacity(cfg, spec.mixer == "local", max_seq)
        if cap % n_cap:
            raise ValueError(f"cache capacity {cap} does not divide over {n_cap} ranks")
        return cap // n_cap

    def one(spec: BlockSpec) -> Dict[str, torch.Tensor]:
        if spec.mixer == "mamba":
            return ssm_lib.init_ssm_state(cfg, batch, device=device)
        if spec.mixer == "xattn":
            return {}
        return init_kv_cache(cfg, batch, capacity(spec), device=device)

    lead = [one(cfg.block_spec(i)) for i in range(cfg.first_k_dense)]
    scan = []
    for spec in cfg.period_specs():
        per_repeat = [one(spec) for _ in range(cfg.n_repeats)]
        scan.append(_stack(per_repeat) if per_repeat and per_repeat[0] else {})
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
    vision: Optional[torch.Tensor] = None,
    caches: Optional[Params] = None,
    plain_attention: bool = False,
    return_aux: bool = False,
    remat: bool = False,
):
    """Returns (hidden states, caches), and the summed MoE aux losses
    (:data:`AUX_KEYS`) third with ``return_aux=True``. The caches are
    updated in place. ``remat=True`` recomputes each scanned block in the
    backward pass, as the reference rematerialises its scan body (the
    ``first_k_dense`` lead blocks are kept, as there)."""
    aux = _zero_aux(x.device)
    for i in range(cfg.first_k_dense):
        c = caches["lead"][i] if caches is not None else None
        x, a = apply_block(
            cfg,
            cfg.block_spec(i),
            params["lead"][i],
            x,
            positions=positions,
            vision=vision,
            cache=c,
            plain_attention=plain_attention,
        )
        aux = _add_aux(aux, a)
    specs = cfg.period_specs()
    for r in range(cfg.n_repeats):
        for j, spec in enumerate(specs):
            block = tree_map(lambda t, r=r: t[r], params["scan"][j])
            c = None
            if caches is not None:
                c = tree_map(lambda t, r=r: t[r], caches["scan"][j])
            kw = dict(positions=positions, vision=vision, cache=c, plain_attention=plain_attention)
            if remat:
                x, a = checkpoint(apply_block, cfg, spec, block, x, use_reentrant=False, **kw)
            else:
                x, a = apply_block(cfg, spec, block, x, **kw)
            aux = _add_aux(aux, a)
    if return_aux:
        return x, caches, aux
    return x, caches
