"""Wrapper of the sliding-window aggregation kernels (``csrc/window_agg.cu``).

A CUDA tensor launches one of the three kernels on the current stream, the
one :func:`window_plan` picks by shape and alignment; a non-contiguous x is
copied to a contiguous one first (the JAX wrapper pads, so copies, its
input). A CPU tensor of any strides and window takes the plain version in
:mod:`repro_torch.kernels.window_agg.ref`. Nothing falls back from one to
the other.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.window_agg.ref import window_agg_ref

AGGS = {"sum": 0, "mean": 1, "max": 2}
#: shared memory a block may use on Hopper (227 KB, opt-in above 48 KB)
SMEM_BYTES = 232_448
#: elements a block of the general kernel aims to own (8 per thread of 256)
TILE_ELEMS = 2048
#: the scan kernel: the C it is built for (one float4 a row), its largest
#: window (two 32-row chunks), and the rows a block walks (4 warps of 8
#: chunks of 32 rows)
SCAN_COLS = 4
SCAN_MAX_WINDOW = 32
SCAN_BLOCK_ROWS = 4 * 8 * 32
#: threads a block of the global kernel (one output element a thread)
GLOBAL_THREADS = 256


@dataclass(frozen=True)
class WindowPlan:
    """Which kernel a call launches and how: ``"scan"`` (C = 4, w <= 32,
    in registers), ``"general"`` (``tile_rows`` rows and their halo a
    block in shared memory) or ``"global"`` (a window too long for shared
    memory, read from device memory). ``w`` is the window clamped to
    [1, S]; ``blocks`` is the grid."""

    variant: str
    w: int
    blocks: int
    tile_rows: int = 0


def tile_room(c: int, w: int) -> int:
    """Rows of ``c`` floats a block's shared memory holds beside a halo of
    ``w - 1`` rows; below 1 when not even one row and its halo fit."""
    return SMEM_BYTES // (4 * c) - (w - 1)


def tile_rows(s: int, c: int, w: int) -> int:
    """Rows per block of the general kernel: about :data:`TILE_ELEMS`
    outputs, fewer when the tile plus its ``w - 1`` halo rows would not fit
    in shared memory.

    Raises when even a one-row tile's halo does not fit: the counterpart of
    the TPU kernel's ``window <= block_s`` precondition."""
    fit = tile_room(c, w)
    if fit < 1:
        raise ValueError(
            f"window {w} over {c} columns needs {4 * w * c} bytes of shared "
            f"memory per block; at most {SMEM_BYTES} fit"
        )
    return max(1, min(s, TILE_ELEMS // c, fit))


def window_plan(s: int, c: int, window: int, agg: str, x_ptr: int) -> WindowPlan:
    """The kernel for x (``s``, ``c``) at address ``x_ptr``: the scan one
    for C = 4, a window of at most 32 rows and a 16-byte aligned x; the
    general one beyond, as long as its halo fits in shared memory; the
    global one past that."""
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    w = max(1, min(window, s))
    if c == SCAN_COLS and w <= SCAN_MAX_WINDOW and x_ptr % 16 == 0:
        return WindowPlan("scan", w, blocks=-(-s // SCAN_BLOCK_ROWS))
    if tile_room(max(c, 1), w) < 1:
        return WindowPlan("global", w, blocks=-(-s * c // GLOBAL_THREADS))
    rows = tile_rows(s, max(c, 1), w)
    return WindowPlan("general", w, blocks=-(-s // rows), tile_rows=rows)


def window_agg(x: torch.Tensor, *, window: int, agg: str = "mean") -> torch.Tensor:
    """x (S, C) float32 → (S, C): causal sliding-window sum, mean or max.

    ``window_agg.launches`` counts kernel launches."""
    if x.dim() != 2:
        raise ValueError(f"window_agg wants x (S, C), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"window_agg wants float32, got {x.dtype}")
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    if x.device.type == "cpu":
        return window_agg_ref(x, window=window, agg=agg)
    if x.device.type != "cuda":
        raise ValueError(f"window_agg runs on cuda or cpu, not {x.device}")
    x = x.contiguous()
    s, c = x.shape
    plan = window_plan(s, c, window, agg, x.data_ptr())
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library("window_agg")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "scan":
            err = lib.window_agg_scan_f32(
                x.data_ptr(), out.data_ptr(), s, plan.w, AGGS[agg], plan.blocks, stream
            )
        elif plan.variant == "global":
            err = lib.window_agg_global_f32(
                x.data_ptr(), out.data_ptr(), s, c, plan.w, AGGS[agg], plan.blocks, stream
            )
        else:
            err = lib.window_agg_f32(
                x.data_ptr(), out.data_ptr(), s, c, plan.w, AGGS[agg], plan.tile_rows, stream
            )
    _build.check(err, "window_agg")
    window_agg.launches += 1
    return out


window_agg.launches = 0


def kernel_attributes(plan: WindowPlan, agg: str) -> Dict[str, int]:
    """Registers a thread, static shared memory a block and local (spill)
    bytes a thread of the kernel ``plan`` launches for ``agg``
    (``cudaFuncGetAttributes``; the general kernel's shared memory is
    dynamic, ``(tile_rows + w - 1) * C`` floats); needs the card."""
    out = (ctypes.c_int * 3)()
    variant = {"general": 0, "scan": 1, "global": 2}[plan.variant]
    err = _build.library("window_agg").window_agg_attributes(variant, AGGS[agg], out)
    _build.check(err, "window_agg_attributes")
    return dict(zip(("registers", "static_smem", "local_bytes"), out))
