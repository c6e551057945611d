"""Plain torch version of the decode-attention kernel.

Follows the TPU kernel, not its jnp oracle, on a row with no valid slot:
masked probabilities are 0 and the denominator is clamped at 1e-30, so
such a row gives 0 (``repro.kernels.decode_attention.ref`` gives the mean
of v there).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, Hq, D), k/v (B, C, Hkv, D), valid (B, C) bool → (B, Hq, D).

    Query head h reads kv head h // (Hq // Hkv); KV is never expanded."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, hq // hkv, d).float() * scale
    s = torch.einsum("bhgd,bchd->bhgc", qg, k.float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    if valid is None:
        valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    mask = valid[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    out = torch.einsum("bhgc,bchd->bhgd", p, v.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_split_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *,
    n_split: int,
    split: int,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The split kernels' algorithm in plain torch: per range of ``split``
    slots a partial (m, l, acc) with m = -1e30 and l = 0 where the range
    has no valid slot, then the combine, which merges the partials in
    split order (each step rescales the running sums and the partial to
    their common max) and clamps the denominator at 1e-30. Same function
    as :func:`decode_attention_ref`."""
    b, hq, d = q.shape
    c, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if valid is None:
        valid = torch.ones((b, c), dtype=torch.bool, device=k.device)
    qg = q.reshape(b, hkv, hq // hkv, d).float() * scale
    s = torch.einsum("bhgd,bchd->bhgc", qg, k.float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        lo, hi = i * split, min(c, (i + 1) * split)
        mask = valid[:, None, None, lo:hi]
        si = torch.where(mask, s[..., lo:hi], torch.full_like(s[..., lo:hi], NEG_INF))
        m = si.amax(-1) if hi > lo else torch.full(s.shape[:-1], NEG_INF, device=s.device)
        p = torch.where(mask, torch.exp(si - m[..., None]), torch.zeros_like(si))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgc,bchd->bhgd", p, v[:, lo:hi].float()))
    mx = torch.full_like(ls[0], NEG_INF)
    num = torch.zeros_like(accs[0])
    den = torch.zeros_like(ls[0])
    for m, l, acc in zip(ms, ls, accs, strict=True):
        m_n = torch.maximum(mx, m)
        f, f_s = torch.exp(mx - m_n), torch.exp(m - m_n)
        den = den * f + l * f_s
        num = num * f[..., None] + acc * f_s[..., None]
        mx = m_n
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)
