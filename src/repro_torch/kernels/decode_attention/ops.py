"""Wrapper of the decode-attention kernels (``csrc/decode_attention.cu``).

Same contract as the JAX wrapper: q (B, Hq, D), the cache's k/v
(B, C, Hkv, D) and a per-slot ``valid`` (B, C) mask. The kernel masks on
``valid`` alone, so a caller with causal or window masks folds them into
it (``repro_torch.models.layers.attention_block`` does). Nothing is
padded: the kernels take any C and any D. The cache is cut into the
splits of :func:`split_plan`; one kernel attends over each split of each
(b, kv head) and a second merges the splits' partial softmaxes from
float32 scratch allocated here. Beyond D = 256 the splits go to the wide
kernel instead (:func:`decode_variant`), which writes the same partials
for the same merge. A non-contiguous input is copied to a contiguous one
first, as the JAX wrapper's padding copies. A CUDA tensor launches the
kernels on the current stream; a CPU tensor of any strides and head dim
takes the plain version in :mod:`repro_torch.kernels.decode_attention.ref`.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

#: the kernel's entry point per input type
ENTRY = {torch.float32: "decode_attention_f32", torch.bfloat16: "decode_attention_bf16"}
#: the wide kernel's entry point per input type
WIDE_ENTRY = {torch.float32: "decode_attention_wide_f32", torch.bfloat16: "decode_attention_wide_bf16"}
#: the largest D of the split kernel; the wide one beyond
MAX_HEAD_DIM = 256
#: the fewest slots a split gets, so that a block has a few loads per warp
MIN_SPLIT = 64
#: blocks per SM the plan aims at
BLOCKS_PER_SM = 2


def split_plan(b: int, hkv: int, c: int, n_sm: int) -> Tuple[int, int]:
    """(n_split, split): the cache's C slots cut into n_split consecutive
    ranges of ``split`` slots (the last may be shorter), so that the
    B * Hkv * n_split blocks give each of ``n_sm`` SMs at least
    :data:`BLOCKS_PER_SM`, with at least :data:`MIN_SPLIT` slots a split.
    n_split is a power of two before the minimum cuts it; no range is
    empty unless C is 0, which gives (1, 0)."""
    if c <= 0:
        return 1, 0
    want = -(-BLOCKS_PER_SM * n_sm // max(1, b * hkv))
    n = 1 << max(0, want - 1).bit_length()
    per = -(-c // n)
    split = max(MIN_SPLIT, -(-per // 16) * 16)  # a multiple of 16 slots
    return -(-c // split), split


def decode_variant(d: int) -> str:
    """The split kernel a call at head dim ``d`` launches: ``"wide"`` above
    :data:`MAX_HEAD_DIM`, else ``"split"``."""
    return "wide" if d > MAX_HEAD_DIM else "split"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v, valid) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"decode_attention wants q (B, Hq, D) and k, v (B, C, Hkv, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if k.shape[2] < 1 or hq % k.shape[2]:
        raise ValueError("Hq must be a multiple of Hkv")
    if d < 1:
        raise ValueError(f"head_dim {d} < 1")
    if q.dtype not in ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"decode_attention wants float32 or bfloat16 alike, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if valid.shape != k.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool {tuple(k.shape[:2])}")
    if not (q.device == k.device == v.device == valid.device):
        raise ValueError(
            f"q on {q.device}, k on {k.device}, v on {v.device}, valid on {valid.device}"
        )


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, Hq, D), k/v (B, C, Hkv, D), valid (B, C) bool → (B, Hq, D).

    A row with no valid slot gives 0. ``decode_attention.launches`` counts
    calls that ran on the card; each launches two kernels (the splits and
    their combine)."""
    if valid is None:
        valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    _check(q, k, v, valid)
    b, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid, softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    _build.refuse_grad("decode_attention", q, k, v)
    q, k, v, valid = (t.contiguous() for t in (q, k, v, valid))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    c, hkv = k.shape[1], k.shape[2]
    n_split, split = split_plan(b, hkv, c, _sm_count(q.device.index or 0))
    part_acc = torch.empty((n_split, b, hq, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((n_split, b, hq, 2), dtype=torch.float32, device=q.device)
    entry = WIDE_ENTRY if decode_variant(d) == "wide" else ENTRY
    fn = getattr(_build.library("decode_attention"), entry[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            valid.data_ptr(),
            out.data_ptr(),
            part_acc.data_ptr(),
            part_ml.data_ptr(),
            b,
            c,
            hq,
            hkv,
            d,
            n_split,
            split,
            float(softcap),
            float(scale),
            stream,
        )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def kernel_attributes(dtype: torch.dtype, d: int, g: int) -> Dict[str, int]:
    """Registers a thread, static and dynamic shared memory a block, and
    local (spill) bytes a thread of the split kernel that a call in
    ``dtype`` at head dim ``d`` and query group ``g`` launches
    (``cudaFuncGetAttributes``); needs the card."""
    out = (ctypes.c_int * 4)()
    err = _build.library("decode_attention").decode_attention_attributes(
        int(dtype == torch.bfloat16), d, g, out
    )
    _build.check(err, "decode_attention_attributes")
    return dict(zip(("registers", "static_smem", "local_bytes", "dynamic_smem"), out))
