"""Core decoder layers: norms, RoPE, GQA attention, MLP, embed and head.

A port of ``repro.models.layers`` over torch tensors, with the same
parameter names and layouts. Attention goes through the hand-written
kernels: a prompt (Sq > 1) through ``flash_attention``, a one-token
decode over a KV cache through ``decode_attention``. The plain
online-softmax :func:`chunked_attention` stays beside them as their
oracle (``plain_attention=True``) and for cross-attention, which the
kernels do not take (non-causal, Sq ≠ Skv).

Everything is a function over an explicit parameter dict; ``init_*``
functions draw from an explicit :class:`torch.Generator` on an explicit
device, with the JAX version's distributions and scales.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as C
from repro_torch.distributed.compat import shard_map
from repro_torch.distributed.sharding import P, block_start, current_rules, sharded_extent
from repro_torch.kernels._build import requires_grad
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import update_cache

Params = Dict[str, Any]

NEG_INF = -1e30


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _normal(cfg: ModelConfig, shape, std: float, gen: torch.Generator, device):
    x = torch.randn(shape, generator=gen, device=device, dtype=_dtype(cfg.param_dtype))
    return x * std


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    pd = _dtype(cfg.param_dtype)
    p = {"scale": torch.ones((d,), dtype=pd, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=pd, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    if cfg.norm == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        var = (x * x).mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float()
    return y.to(dt)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMSNorm over head_dim (qwen3 qk-norm)."""
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def _rotary_dim(cfg: ModelConfig) -> int:
    return int(cfg.head_dim * cfg.rotary_pct) // 2 * 2


def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    rot = _rotary_dim(cfg)
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta**exps)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates the first
    ``rotary_pct`` fraction of D (pairwise halves convention)."""
    rot = _rotary_dim(cfg)
    if rot == 0:
        return x
    inv = rope_freqs(cfg, x.device)  # (rot/2,)
    ang = positions.float()[..., None] * inv  # (B,S,rot/2)
    cos = torch.cos(ang)[:, :, None, :]  # (B,S,1,rot/2)
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2 :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], -1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    std = 1.0 / math.sqrt(d)
    pd = _dtype(cfg.param_dtype)
    p: Params = {
        "wq": _normal(cfg, (d, q_dim), std, gen, device),
        "wk": _normal(cfg, (d, kv_dim), std, gen, device),
        "wv": _normal(cfg, (d, kv_dim), std, gen, device),
        "wo": _normal(cfg, (q_dim, d), std / math.sqrt(2 * cfg.n_layers), gen, device),
    }
    if cfg.use_bias:
        for name, n in (("bq", q_dim), ("bk", kv_dim), ("bv", kv_dim), ("bo", d)):
            p[name] = torch.zeros((n,), dtype=pd, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=pd, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=pd, device=device)
    return p


def _project_qkv(
    cfg: ModelConfig, p: Params, x: torch.Tensor, kv_x: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ q: (B,Sq,Hq,D), k/v: (B,Skv,Hkv,D). ``kv_x`` for cross-attention."""
    kv_src = x if kv_x is None else kv_x
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = kv_src @ p["wk"].to(dt)
    v = kv_src @ p["wv"].to(dt)
    if cfg.use_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    b, sq = q.shape[:2]
    skv = k.shape[1]
    q = q.reshape(b, sq, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_head_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attend_chunk(qf, qpos, m, lsum, acc, kb, vb, pb, valid, causal, window, softcap):
    """One KV chunk's step of the online softmax: (m, lsum, acc) updated."""
    s = torch.einsum("bqhgd,bchd->bqhgc", qf, kb.float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = valid[:, None, :]  # (B,1,c)
    if causal:
        mask = mask & (pb[:, None, :] <= qpos[:, :, None])
    if window > 0:
        mask = mask & (pb[:, None, :] > qpos[:, :, None] - window)
    s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p_ = torch.exp(s - m_new[..., None])
    lsum = lsum * alpha + p_.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bqhgc,bchd->bqhgd", p_, vb.float())
    return m_new, lsum, acc


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the plain version).

    q: (B,Sq,Hq,D) · k,v: (B,Skv,Hkv,D) · positions: (B,S) absolute token
    indices (drive causal/window masks; decode passes offsets here).
    kv_valid: (B,Skv) bool for ring-buffer caches with unwritten slots.
    Grouped-query: Hq % Hkv == 0; scores in f32, output in q.dtype.

    Under autograd each chunk's step runs under ``torch.utils.checkpoint``,
    as the reference's ``jax.checkpoint`` body: the backward pass
    recomputes a chunk's (B,Sq,Hkv,G,chunk) float32 scores instead of
    keeping them for every chunk of every layer.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    qf = (q.float() * scale).reshape(b, sq, hkv, g, d)
    qpos = q_positions.to(torch.int32)
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=q.device)
    remat = requires_grad(q, k, v)
    for c0 in range(0, skv, chunk):
        args = (qf, qpos, m, lsum, acc) + tuple(
            t[:, c0 : c0 + chunk] for t in (k, v, kv_positions, kv_valid)
        )
        if remat:
            m, lsum, acc = checkpoint(
                _attend_chunk, *args, causal, window, softcap, use_reentrant=False
            )
        else:
            m, lsum, acc = _attend_chunk(*args, causal, window, softcap)
    out = acc / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(b, sq, hq, d).to(q.dtype)


def sharded_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    window: int,
    softcap: float,
    rules: Any,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-decode over a CAPACITY-sharded cache (the reference's §Perf path).

    Each rank computes online-softmax stats (m, l, acc) over its block of
    the cache's slots; the stats merge with one all-reduce MAX of m and
    one all-reduce SUM each of the corrected l and acc over "model": wire
    bytes O(B·Hq·D) a layer instead of gathering the cache. The body is
    the plain version, as the reference's is plain ``jnp`` in
    ``shard_map``; masked scores are -1e30, so a block with no valid slot
    contributes exp(-1e30 - m_g) = 0.

    q: (B, 1, Hq, D) replicated over "model"; k/v: (B, C, Hkv, D) with C
    sharded over "model"; positions/valid sharded alike. Plain tensors are
    the rank's blocks.
    """
    tp_axis = "model"
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale_ = scale if scale is not None else 1.0 / math.sqrt(d)
    b_rule = rules.dim_rule("batch", b)
    cap_rule = rules.dim_rule("cache_cap", k.shape[1])

    def body(q_l, k_l, v_l, pos_l, valid_l, qpos_l):
        qf = (q_l.float() * scale_).reshape(q_l.shape[0], hkv, g, d)  # (B,Hkv,G,D)
        s = torch.einsum("bhgd,bchd->bhgc", qf, k_l.float())
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        mask = valid_l[:, None, None, :] & (pos_l[:, None, None, :] <= qpos_l[:, None, None, None])
        if window > 0:
            mask = mask & (pos_l[:, None, None, :] > qpos_l[:, None, None, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(-1)  # (B,Hkv,G)
        p_ = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        lsum = p_.sum(-1)
        acc = torch.einsum("bhgc,bchd->bhgd", p_, v_l.float())
        # merge partial softmax stats across capacity shards
        m_g = C.pmax(m, tp_axis)
        corr = torch.exp(m - m_g)
        lsum_g = C.psum(lsum * corr, tp_axis)
        acc_g = C.psum(acc * corr[..., None], tp_axis)
        out = acc_g / lsum_g.clamp_min(1e-30)[..., None]
        return out.reshape(q_l.shape[0], 1, hq, d).to(q_l.dtype)

    return shard_map(
        body,
        rules.mesh,
        in_specs=(
            P(b_rule, None, None, None),
            P(b_rule, cap_rule, None, None),
            P(b_rule, cap_rule, None, None),
            P(b_rule, cap_rule),
            P(b_rule, cap_rule),
            P(b_rule),
        ),
        out_specs=P(b_rule, None, None, None),
    )(q, k, v, kv_positions, kv_valid, q_positions[:, 0])


def attention_block(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    local: bool,
    kv_x: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    plain_attention: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full attention sub-block: project → rope → (cache update) → attend →
    output projection. Returns (output, updated_cache).

    Attention runs on the kernels: ``decode_attention`` for one token over
    a cache (its causal and window masks folded into the slots' valid
    mask), ``flash_attention`` otherwise, which assumes each row's
    positions are consecutive (prefill and forward pass 0..S-1).
    ``plain_attention=True`` runs :func:`chunked_attention` instead, as
    cross-attention always does. Under sharding rules with
    ``decode_flash_shard`` the cache is the rank's block of slots and a
    decode step runs :func:`sharded_decode_attention`."""
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    cross = kv_x is not None
    window = cfg.sliding_window if local else 0
    softcap = cfg.attn_logit_softcap
    if not cross:
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, positions if kv_positions is None else kv_positions)
    kv_valid = None
    decode = False
    if cache is not None and not cross:
        rules = current_rules()
        flash_shard = rules is not None and rules.options.get("decode_flash_shard")
        n_cap = sharded_extent(rules, "cache_cap") if flash_shard else 1
        shard = None
        if n_cap > 1:  # the cache holds the rank's block of slots
            c_local = cache["k"].shape[1]
            shard = (block_start(rules, "cache_cap", c_local), c_local * n_cap)
        cache, k_all, v_all, pos_all, valid_all = update_cache(cache, k, v, positions, shard)
        if q.shape[1] == 1 and flash_shard:
            out = sharded_decode_attention(
                q,
                k_all,
                v_all,
                q_positions=positions,
                kv_positions=pos_all,
                kv_valid=valid_all,
                window=window,
                softcap=softcap,
                rules=rules,
            )
            b, s = out.shape[:2]
            out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
            y = out @ p["wo"].to(out.dtype)
            if cfg.use_bias:
                y = y + p["bo"].to(out.dtype)
            return y, cache
        if q.shape[1] == 1:
            # decode: attend over the cache view (ring wraparound handled
            # by absolute positions + validity mask)
            k, v, kv_pos, kv_valid = k_all, v_all, pos_all, valid_all
            decode = True
        else:
            # prefill from empty cache: attend in-segment (the ring may be
            # smaller than the segment), cache updated above for decode
            kv_pos = positions
    else:
        kv_pos = positions if kv_positions is None else kv_positions
        if cross:
            kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
            kv_pos = kv_pos[None].expand(k.shape[0], -1)
    if plain_attention or cross:
        out = chunked_attention(
            q,
            k,
            v,
            q_positions=positions,
            kv_positions=kv_pos,
            kv_valid=kv_valid,
            causal=not cross,
            window=window,
            softcap=softcap,
            chunk=cfg.attn_chunk,
        )
    elif decode:
        qpos = positions.to(torch.int32)  # (B, 1)
        valid = kv_valid & (kv_pos <= qpos)
        if window > 0:
            valid = valid & (kv_pos > qpos - window)
        out = decode_attention(q[:, 0], k, v, valid, softcap=softcap)[:, None]
    else:
        out = flash_attention(q, k, v, causal=True, window=window, softcap=softcap)
    b, s = out.shape[:2]
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    y = out @ p["wo"].to(out.dtype)
    if cfg.use_bias:
        y = y + p["bo"].to(out.dtype)
    return y, cache


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, gen: torch.Generator, device, d_ff=None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    std = 1.0 / math.sqrt(d)
    return {
        "wi": _normal(cfg, (d, f), std, gen, device),
        "wg": _normal(cfg, (d, f), std, gen, device),
        "wo": _normal(cfg, (f, d), std / math.sqrt(2 * cfg.n_layers), gen, device),
    }


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = _act(cfg, x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embed(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    p = {"embedding": _normal(cfg, (cfg.vocab_size, cfg.d_model), 0.02, gen, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(cfg, (cfg.d_model, cfg.vocab_size), 0.02, gen, device)
    return p


def embed_tokens(cfg: ModelConfig, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = p["embedding"][tokens.long()].to(_dtype(cfg.dtype))
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def lm_logits(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
