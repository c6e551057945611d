"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``).

Takes the model's layout, q (B, S, Hq, D) and k/v (B, S, Hkv, D), as the
JAX wrapper does. Unlike it, kv heads are not repeated: the kernels read
kv head ``h // (Hq // Hkv)`` themselves and mask the ragged S. Up to
D = 256, float32 runs on the CUDA cores, and bf16 runs on the tensor cores
with TMA loads, whose rows must be 16-byte aligned: a D that is not a
multiple of 8 is zero-padded to one here (:func:`pad_head_dim`; the JAX
wrapper pads to 128 lanes) and the output sliced back, and a q, k or v
that is not 16-byte aligned is copied. Beyond D = 256 both types take the
wide kernel on the CUDA cores (:func:`flash_variant`). A non-contiguous
input is copied to a contiguous one first, as the JAX wrapper's padding
copies. A CUDA tensor launches a kernel on the current stream; a CPU
tensor of any strides and head dim takes the plain version in
:mod:`repro_torch.kernels.flash_attention.ref`. Nothing falls back from
one to the other.

On the card, an input that requires grad (training) goes through
:class:`FlashAttentionFn`: its forward is the kernel launch, and its
backward is autograd through the plain ``chunked_attention`` recomputed
from the saved q, k and v, the function whose gradient the reference's
training takes. No backward kernel is written: the reference has none.
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
#: the wide kernel's entry point per input type
WIDE_ENTRY = {torch.float32: "flash_attention_wide_f32", torch.bfloat16: "flash_attention_wide_bf16"}
#: the largest D of the float32 and tensor-core kernels; the wide one beyond
MAX_HEAD_DIM = 256
#: the bf16 kernel's D granularity: TMA wants 16-byte row strides
BF16_HEAD_DIM_MULTIPLE = 8


def flash_variant(d: int) -> str:
    """The kernel a call at head dim ``d`` launches: ``"wide"`` above
    :data:`MAX_HEAD_DIM`, else the one for its type (``"tile"``)."""
    return "wide" if d > MAX_HEAD_DIM else "tile"


def padded_head_dim(d: int, dtype: torch.dtype) -> int:
    """The D the kernel for ``dtype`` is given for a head dim of ``d``."""
    if dtype != torch.bfloat16 or flash_variant(d) == "wide":
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
    if d < 1:
        raise ValueError(f"head_dim {d} < 1")
    if q.dtype not in ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention wants float32 or bfloat16 alike, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


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
    launches. On the card an input that requires grad, with grad enabled,
    goes through :class:`FlashAttentionFn`."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
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
    if _build.requires_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap, scale)
    return _launch(q, k, v, causal, window, softcap, scale)


def _launch(q, k, v, causal, window, softcap, scale) -> torch.Tensor:
    """The kernel on CUDA tensors q, k, v; counts the launch."""
    b, s, hq, d = q.shape
    if q.numel() == 0:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    d_pad = padded_head_dim(d, q.dtype)
    q, k, v = (pad_head_dim(t, d_pad).contiguous() for t in (q, k, v))
    wide = flash_variant(d) == "wide"
    if q.dtype == torch.bfloat16 and not wide:  # TMA reads 16-byte aligned rows
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    fn = getattr(_build.library("flash_attention"), (WIDE_ENTRY if wide else ENTRY)[q.dtype])
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


class FlashAttentionFn(torch.autograd.Function):
    """The kernel's output with the reference's gradient.

    ``forward`` launches the kernel and saves q, k, v. ``backward``
    recomputes the plain ``chunked_attention`` (positions 0..S-1, the same
    causal, window, softcap and scale) on them and backpropagates through
    it, as the reference's training differentiates that function."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.attention = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return _launch(q, k, v, causal, window, softcap, scale)

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.models.layers import chunked_attention

        q, k, v = ctx.saved_tensors
        b, s = q.shape[:2]
        pos = torch.arange(s, dtype=torch.int32, device=q.device)[None].expand(b, s)
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = chunked_attention(*inputs, q_positions=pos, kv_positions=pos, **ctx.attention)
            grads = torch.autograd.grad(out, inputs, grad)
        grads = [g if need else None for g, need in zip(grads, ctx.needs_input_grad, strict=False)]
        return (*grads, None, None, None, None)


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
