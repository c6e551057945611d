"""Wrapper of the k-means assignment kernels (``csrc/kmeans_assign.cu``).

A CUDA tensor launches one of the two kernels on the current stream, the one
:func:`kmeans_plan` picks by shape and alignment; a non-contiguous x or
cent is copied to a contiguous one first (the JAX wrapper pads, so copies,
every input). A CPU tensor of any strides takes the plain version in
:mod:`repro_torch.kernels.kmeans.ref`. Nothing falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kmeans.ref import kmeans_assign_ref

#: shared memory a block of the general kernel stages centroids in (the
#: default dynamic limit)
STAGE_BYTES = 48 * 1024
#: the tiled kernel: points a thread owns, threads a block, the D it is
#: built for, and its bounds on K (a call takes the least bound >= K)
TILED_POINTS = 4
TILED_THREADS = 128
TILED_DIMS = (1, 2, 3, 4)
TILED_KMAX = (4, 8, 16)


@dataclass(frozen=True)
class KmeansPlan:
    """Which kernel a call launches and how.

    ``variant`` is ``"tiled"`` (templated on D and ``kmax``; 16-byte loads
    of x when ``vector``) or ``"general"`` (centroids staged ``chunk_k`` at
    a time in shared memory). ``blocks`` is the grid."""

    variant: str
    blocks: int
    kmax: int = 0
    vector: bool = False
    chunk_k: int = 0


def centroid_chunk(k: int, d: int) -> int:
    """Centroids the general kernel stages in shared memory per pass; 0
    when one row of ``d`` floats exceeds :data:`STAGE_BYTES` and it reads
    the centroids from device memory instead."""
    rows = STAGE_BYTES // (4 * d)
    return min(k, rows)


def kmeans_plan(n: int, d: int, k: int, x_ptr: int) -> KmeansPlan:
    """The kernel for x (``n``, ``d``) at address ``x_ptr`` against ``k``
    centroids: the tiled one for D <= 4 and K <= 16, reading x in 16-byte
    loads when ``x_ptr`` is 16-byte aligned (a view such as ``x[1:]`` may
    not be) and in 4-byte loads otherwise; the general one beyond."""
    if d in TILED_DIMS and k <= TILED_KMAX[-1]:
        threads = -(-n // TILED_POINTS)
        return KmeansPlan(
            "tiled",
            blocks=-(-threads // TILED_THREADS),
            kmax=min(b for b in TILED_KMAX if b >= k),
            vector=x_ptr % 16 == 0,
        )
    return KmeansPlan("general", blocks=-(-n // 256), chunk_k=centroid_chunk(k, d))


def _check(x: torch.Tensor, cent: torch.Tensor) -> None:
    if x.dim() != 2 or cent.dim() != 2 or x.shape[1] != cent.shape[1]:
        raise ValueError(
            f"kmeans_assign wants x (N, D) and cent (K, D), got "
            f"{tuple(x.shape)} and {tuple(cent.shape)}"
        )
    if cent.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError("kmeans_assign needs K >= 1 centroids and D >= 1")
    if x.dtype != torch.float32 or cent.dtype != torch.float32:
        raise TypeError(f"kmeans_assign wants float32, got {x.dtype}, {cent.dtype}")
    if x.device != cent.device:
        raise ValueError(f"x on {x.device} but cent on {cent.device}")


def kmeans_assign(
    x: torch.Tensor, cent: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), cent (K, D) float32 → (assign (N,) int32, min_d2 (N,) f32).

    ``kmeans_assign.launches`` counts kernel launches."""
    _check(x, cent)
    if x.device.type == "cpu":
        return kmeans_assign_ref(x, cent)
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign runs on cuda or cpu, not {x.device}")
    x, cent = x.contiguous(), cent.contiguous()
    n, d = x.shape
    k = cent.shape[0]
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    min_d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, min_d2
    plan = kmeans_plan(n, d, k, x.data_ptr())
    lib = _build.library("kmeans_assign")
    ptrs = (x.data_ptr(), cent.data_ptr(), assign.data_ptr(), min_d2.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "tiled":
            err = lib.kmeans_assign_tiled_f32(
                *ptrs, n, d, k, plan.kmax, int(plan.vector), plan.blocks, stream
            )
        else:
            err = lib.kmeans_assign_f32(*ptrs, n, d, k, plan.chunk_k, stream)
    _build.check(err, "kmeans_assign")
    kmeans_assign.launches += 1
    return assign, min_d2


kmeans_assign.launches = 0


def kernel_attributes(plan: KmeansPlan, d: int) -> Dict[str, int]:
    """Registers a thread, static shared memory a block and local (spill)
    bytes a thread of the kernel ``plan`` launches at dimension ``d``
    (``cudaFuncGetAttributes``); needs the card."""
    out = (ctypes.c_int * 3)()
    err = _build.library("kmeans_assign").kmeans_assign_attributes(
        int(plan.variant == "tiled"), d, plan.kmax, int(plan.vector), out
    )
    _build.check(err, "kmeans_assign_attributes")
    return dict(zip(("registers", "static_smem", "local_bytes"), out))
