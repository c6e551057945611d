"""Wrapper of the k-means assignment kernel (``csrc/kmeans_assign.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in :mod:`repro_torch.kernels.kmeans.ref`. Nothing falls
back from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kmeans.ref import kmeans_assign_ref

#: shared memory a block stages centroids in (the default dynamic limit)
STAGE_BYTES = 48 * 1024


def centroid_chunk(k: int, d: int) -> int:
    """Centroids staged in shared memory per pass; 0 when one row of ``d``
    floats exceeds :data:`STAGE_BYTES` and the kernel reads the centroids
    from device memory instead."""
    rows = STAGE_BYTES // (4 * d)
    return min(k, rows)


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
    if not (x.is_contiguous() and cent.is_contiguous()):
        raise ValueError("kmeans_assign wants contiguous x and cent")


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
    n, d = x.shape
    k = cent.shape[0]
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    min_d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, min_d2
    fn = _build.library("kmeans_assign")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(),
            cent.data_ptr(),
            assign.data_ptr(),
            min_d2.data_ptr(),
            n,
            d,
            k,
            centroid_chunk(k, d),
            stream,
        )
    _build.check(err, "kmeans_assign")
    kmeans_assign.launches += 1
    return assign, min_d2


kmeans_assign.launches = 0
