"""Plain torch version of the flash-attention kernel.

Materialises the full (S, S) score matrix, O(S²) memory: the CPU path of
the wrapper and the kernel's oracle on the card. Same function as
``repro.kernels.flash_attention.ref`` with GQA added: query head ``h``
reads kv head ``h // (Hq // Hkv)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) → (B, Hq, S, D).

    float32 softmax, output in q.dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kf)
    if softcap > 0:
        sc = softcap * torch.tanh(sc / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
