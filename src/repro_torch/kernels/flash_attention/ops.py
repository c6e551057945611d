"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Takes the model's layout, q (B, S, Hq, D) and k/v (B, S, Hkv, D), as the
JAX wrapper does. Unlike it, nothing is repeated or padded: the kernel
reads kv head ``h // (Hq // Hkv)`` itself, masks the ragged S, and takes
any D up to 256. A CUDA tensor launches the kernel on the current stream;
a CPU tensor takes the plain version in
:mod:`repro_torch.kernels.flash_attention.ref`. Nothing falls back from
one to the other.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: the kernel's entry point per input type
ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention wants q (B, S, Hq, D) and k, v (B, S, Hkv, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if k.shape[2] < 1 or hq % k.shape[2]:
        raise ValueError("Hq must be a multiple of Hkv")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention wants float32 or bfloat16 alike, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention wants contiguous q, k and v")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, S, Hkv, D) → (B, S, Hq, D).

    Positions are the token indices 0..S-1 of each row: the causal and
    window masks compare them. ``flash_attention.launches`` counts kernel
    launches."""
    _check(q, k, v)
    b, s, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        out = flash_attention_ref(
            q.transpose(1, 2),
            k.transpose(1, 2),
            v.transpose(1, 2),
            causal=causal,
            window=window,
            softcap=softcap,
            scale=scale,
        )
        return out.transpose(1, 2).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = getattr(_build.library("flash_attention"), ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            b,
            s,
            hq,
            k.shape[2],
            d,
            int(causal),
            int(window),
            float(softcap),
            float(scale),
            stream,
        )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
