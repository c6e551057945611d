"""LM wrapper: embed → backbone → head; loss; prefill; decode.

A port of ``repro.models.model``. Modality frontends enter as
precomputed inputs (``repro_torch.models.frontends``): codec token ids,
or patch embeddings passed as ``vision`` to the cross-attention blocks.
The training loss's remat and chunked CE use
``torch.utils.checkpoint``. Functions over
explicit parameter trees of the JAX package's shape. The weights come
from :func:`init` with a seeded :class:`torch.Generator`, or from the JAX
package's own ``init`` through
``repro_torch.convert.params_from_reference``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def init(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (which must live on ``device``'s type) with the JAX
    ``init``'s distributions: normal × the same per-leaf scales, norms at
    one."""
    p = {
        "embed": L.init_embed(cfg, generator, device),
        "final_norm": L.init_norm(cfg, device),
    }
    p.update(T.init_backbone(cfg, generator, device))
    return p


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """The parameters that only enter products, cast once to ``cfg.dtype``.

    The layers cast every weight to the activation type at each product
    (``w.to(x.dtype)``), as the JAX layers do; casting those weights once
    gives the same values and skips re-reading the float32 masters on
    every step. Norm scales stay as they are: the layers compute norms
    in float32 from them."""
    dt = getattr(torch, cfg.dtype)

    def walk(tree, norm: bool):
        if isinstance(tree, dict):
            return {
                k: walk(v, norm or "norm" in k)
                for k, v in tree.items()  # det: ok key-addressed rebuild
            }
        if isinstance(tree, list):
            return [walk(v, norm) for v in tree]
        return tree if norm else tree.to(dt)

    return walk(params, False)


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    *,
    vision: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    caches: Optional[Params] = None,
    return_hidden: bool = False,
    plain_attention: bool = False,
    return_aux: bool = False,
    remat: bool = False,
):
    """tokens (B, S) int → (logits (B, S, V), caches).

    Caches are updated in place. ``vision`` (B, Nv, d_model) feeds the
    cross-attention blocks. ``return_hidden=True`` skips the LM head and
    returns the final normed hidden states instead. ``return_aux=True``
    appends the MoE aux losses (``transformer.AUX_KEYS``) as a third
    value, the reference's ``aux``. ``remat=True`` recomputes each
    scanned block in the backward pass (``transformer.apply_backbone``)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
        positions = positions[None].expand(b, s)
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = constrain(x, "batch", "seq", None)
    if vision is not None:
        vision = vision.to(x.dtype)
    x, caches, aux = T.apply_backbone(
        cfg,
        params,
        x,
        positions=positions,
        vision=vision,
        caches=caches,
        plain_attention=plain_attention,
        return_aux=True,
        remat=remat,
    )
    x = L.apply_norm(cfg, params["final_norm"], x)
    if not return_hidden:
        x = L.lm_logits(cfg, params["embed"], x)
        x = constrain(x, "batch", "seq", "vocab")
    if return_aux:
        return x, caches, aux
    return x, caches


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def _ce_terms(
    cfg: ModelConfig, embed: Params, x: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ masked CE and Σ mask over a (T, d) hidden slab."""
    logits = L.lm_logits(cfg, embed, x).float()
    mask = (labels != 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None].long())[:, 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def loss_fn(
    cfg: ModelConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    *,
    remat: bool = False,
    loss_chunk: int = 0,
    plain_attention: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {"tokens": (B,S) int, "labels": (B,S) int, pad=0
    [, "vision": (B,Nv,d)]} → (scalar loss, metrics).

    ``loss_chunk > 0`` computes head+CE per token chunk under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): a
    chunk's (T, V) float32 logits live only while it is computed, and are
    computed again in the backward pass. ``plain_attention=True`` runs the
    prompt attention on the plain version instead of the flash kernel."""
    labels = batch["labels"]
    b, s = labels.shape
    kw = dict(
        vision=batch.get("vision"), remat=remat, plain_attention=plain_attention, return_aux=True
    )
    if loss_chunk and (b * s) % loss_chunk == 0:
        x, _, aux = forward(cfg, params, batch["tokens"], return_hidden=True, **kw)
        xf = x.reshape(b * s, -1)
        lf = labels.reshape(b * s)
        ce_sum = m_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, b * s, loss_chunk):
            ce_c, m_c = checkpoint(
                _ce_terms,
                cfg,
                params["embed"],
                xf[c0 : c0 + loss_chunk],
                lf[c0 : c0 + loss_chunk],
                use_reentrant=False,
            )
            ce_sum, m_sum = ce_sum + ce_c, m_sum + m_c
        denom = m_sum.clamp_min(1.0)
        ce_mean = ce_sum / denom
    else:
        logits, _, aux = forward(cfg, params, batch["tokens"], **kw)
        mask = (labels != 0).float()
        logits_f = logits.float()
        lse = torch.logsumexp(logits_f, dim=-1)
        gold = logits_f.gather(-1, labels[..., None].long())[..., 0]
        denom = mask.sum().clamp_min(1.0)
        ce_mean = ((lse - gold) * mask).sum() / denom
    loss = ce_mean + cfg.router_aux_weight * aux["aux_loss"] + cfg.router_z_weight * aux["z_loss"]
    metrics = {
        "ce": ce_mean,
        "loss": loss,
        "tokens": denom,
        "aux_loss": aux["aux_loss"],
        "z_loss": aux["z_loss"],
        "dropped_frac": aux["dropped_frac"],
    }
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    caches: Params,
    *,
    vision: Optional[torch.Tensor] = None,
    plain_attention: bool = False,
) -> Tuple[torch.Tensor, Params]:
    """Run the prompt through the model, filling caches.

    Returns (last-position logits (B, V), caches)."""
    hidden, caches = forward(
        cfg,
        params,
        tokens,
        vision=vision,
        caches=caches,
        return_hidden=True,
        plain_attention=plain_attention,
    )
    return L.lm_logits(cfg, params["embed"], hidden[:, -1]), caches


def decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,
    pos: torch.Tensor,
    caches: Params,
    *,
    vision: Optional[torch.Tensor] = None,
    plain_attention: bool = False,
) -> Tuple[torch.Tensor, Params]:
    """One decode step. token (B,) int, pos (B,) absolute position.

    Returns (logits (B, V), caches)."""
    logits, caches = forward(
        cfg,
        params,
        token[:, None],
        vision=vision,
        positions=pos[:, None].to(torch.int32),
        caches=caches,
        plain_attention=plain_attention,
    )
    return logits[:, 0], caches


def greedy_generate(
    cfg: ModelConfig,
    params: Params,
    prompt: torch.Tensor,
    n_tokens: int,
    max_seq: int,
    vision: Optional[torch.Tensor] = None,
    *,
    plain_attention: bool = False,
) -> torch.Tensor:
    """Reference greedy decoding (tests/examples; the serving engine in
    repro_torch.serve batches and schedules for real)."""
    b, s = prompt.shape
    caches = T.init_caches(cfg, b, max_seq, device=prompt.device)
    logits, caches = prefill(
        cfg, params, prompt, caches, vision=vision, plain_attention=plain_attention
    )
    out = [torch.argmax(logits, -1)]
    for i in range(n_tokens - 1):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=prompt.device)
        logits, caches = decode_step(
            cfg, params, out[-1], pos, caches, vision=vision, plain_attention=plain_attention
        )
        out.append(torch.argmax(logits, -1))
    return torch.stack(out, dim=1)
