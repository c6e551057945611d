"""Wrapper of the sliding-window aggregation kernel (``csrc/window_agg.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in :mod:`repro_torch.kernels.window_agg.ref`. Nothing
falls back from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.window_agg.ref import window_agg_ref

AGGS = {"sum": 0, "mean": 1, "max": 2}
#: shared memory a block may use on Hopper (227 KB, opt-in above 48 KB)
SMEM_BYTES = 232_448
#: elements a block aims to own (8 per thread of 256)
TILE_ELEMS = 2048


def tile_rows(s: int, c: int, w: int) -> int:
    """Rows per block: about :data:`TILE_ELEMS` outputs, fewer when the
    tile plus its ``w - 1`` halo rows would not fit in shared memory.

    Raises when even a one-row tile's halo does not fit: the counterpart of
    the TPU kernel's ``window <= block_s`` precondition."""
    fit = SMEM_BYTES // (4 * c) - (w - 1)
    if fit < 1:
        raise ValueError(
            f"window {w} over {c} columns needs {4 * w * c} bytes of shared "
            f"memory per block; at most {SMEM_BYTES} fit"
        )
    return max(1, min(s, TILE_ELEMS // c, fit))


def window_agg(x: torch.Tensor, *, window: int, agg: str = "mean") -> torch.Tensor:
    """x (S, C) float32 → (S, C): causal sliding-window sum, mean or max.

    ``window_agg.launches`` counts kernel launches."""
    if x.dim() != 2:
        raise ValueError(f"window_agg wants x (S, C), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"window_agg wants float32, got {x.dtype}")
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    if not x.is_contiguous():
        raise ValueError("window_agg wants a contiguous x")
    s, c = x.shape
    w = max(1, min(window, s))
    rows = tile_rows(s, max(c, 1), w)
    if x.device.type == "cpu":
        return window_agg_ref(x, window=w, agg=agg)
    if x.device.type != "cuda":
        raise ValueError(f"window_agg runs on cuda or cpu, not {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _build.library("window_agg")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), s, c, w, AGGS[agg], rows, stream)
    _build.check(err, "window_agg")
    window_agg.launches += 1
    return out


window_agg.launches = 0
