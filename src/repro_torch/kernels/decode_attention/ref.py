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
