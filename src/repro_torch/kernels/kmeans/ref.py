"""Plain torch version of the k-means assignment kernel.

The CPU path of :func:`repro_torch.kernels.kmeans.ops.kmeans_assign` and the
oracle the CUDA kernel is held against on the card. It uses the kernel's
direct form: the sum over d of (x - c)^2 in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def kmeans_distances(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """x (N, D), cent (K, D) → squared distances (N, K) in float32."""
    diff = x[:, None, :].float() - cent[None, :, :].float()
    return (diff * diff).sum(-1)


def kmeans_assign_ref(
    x: torch.Tensor, cent: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), cent (K, D) → (assign (N,) int32, min_d2 (N,) float32).

    ``argmin`` keeps the first index on ties; ``min_d2`` is clamped at 0."""
    d2 = kmeans_distances(x, cent)
    min_d2, assign = d2.min(dim=1)
    return assign.to(torch.int32), min_d2.clamp_min(0.0)
