"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``).

Takes the model's layout, q (B, S, Hq, D) and k/v (B, S, Hkv, D), as the
JAX wrapper does. Unlike it, kv heads are not repeated: the kernels read
kv head ``h // (Hq // Hkv)`` themselves and mask the ragged S. float32
runs on the CUDA cores and takes any D up to 256. bf16 runs on the tensor
cores with TMA loads, whose rows must be 16-byte aligned: a D that is not
a multiple of 8 is zero-padded to one here (:func:`pad_head_dim`; the
JAX wrapper pads to 128 lanes) and the output sliced back. A CUDA tensor
launches a kernel on the current stream; a CPU tensor takes the plain
version in :mod:`repro_torch.kernels.flash_attention.ref`. Nothing falls
back from one to the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: the kernel's entry point per input type
ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
MAX_HEAD_DIM = 256
#: the bf16 kernel's D granularity: TMA wants 16-byte row strides
BF16_HEAD_DIM_MULTIPLE = 8


def padded_head_dim(d: int, dtype: torch.dtype) -> int:
    """The D the kernel for ``dtype`` is given for a head dim of ``d``."""
    if dtype != torch.bfloat16:
        return d
    return -(-d // BF16_HEAD_DIM_MULTIPLE) * BF16_HEAD_DIM_MULTIPLE


def pad_head_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` with its last dim zero-padded to ``d``: zero columns add
    nothing to q k^T, and give zero output columns."""
    return x if x.shape[-1] == d else F.pad(x, (0, d - x.shape[-1]))


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
    if q.numel() == 0:
        return torch.empty_like(q)
    d_pad = padded_head_dim(d, q.dtype)
    q, k, v = (pad_head_dim(t, d_pad) for t in (q, k, v))
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention wants 16-byte aligned bf16 q, k and v (TMA)")
    out = torch.empty_like(q)
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
            d_pad,
            int(causal),
            int(window),
            float(softcap),
            float(scale),
            stream,
        )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out if d_pad == d else out[..., :d].contiguous()


flash_attention.launches = 0


def kernel_attributes(dtype: torch.dtype, d: int) -> Dict[str, int]:
    """Registers a thread, static and dynamic shared memory a block, and
    local (spill) bytes a thread of the kernel a call in ``dtype`` at head
    dim ``d`` launches (``cudaFuncGetAttributes``); needs the card."""
    out = (ctypes.c_int * 4)()
    d_pad = padded_head_dim(d, dtype)
    err = _build.library("flash_attention").flash_attention_attributes(
        int(dtype == torch.bfloat16), d_pad, out
    )
    _build.check(err, "flash_attention_attributes")
    return dict(zip(("registers", "static_smem", "local_bytes", "dynamic_smem"), out))
