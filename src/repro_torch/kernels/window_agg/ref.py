"""Plain torch version of the sliding-window aggregation kernel.

The CPU path of :func:`repro_torch.kernels.window_agg.ops.window_agg` and
the oracle the CUDA kernel is held against on the card. Causal window of
``window`` rows, clamped at the first row, same-length output, as the
pipeline operator ``window_agg``. Sums are taken in float64 and cast back:
at 500,000 rows a float32 prefix sum of squared inputs loses about 1e-3,
more than the kernel's direct float32 window sums.
"""

from __future__ import annotations

import torch


def window_agg_ref(x: torch.Tensor, *, window: int, agg: str = "mean") -> torch.Tensor:
    """x (S, C) → (S, C); rows [t - w + 1, t] clamped at 0."""
    n = x.shape[0]
    w = max(1, min(window, n))
    t = torch.arange(n, device=x.device)
    lo = (t - w + 1).clamp_min(0)
    if agg in ("sum", "mean"):
        # scan along the contiguous last dim: a cumsum down the rows of a
        # narrow (S, C) tensor runs one sequential scan per column on a GPU
        xd = x.double().t().contiguous()  # (C, S)
        c = torch.cat([xd.new_zeros((x.shape[1], 1)), xd.cumsum(1)], dim=1)
        s = c[:, t + 1] - c[:, lo]
        if agg == "mean":
            s = s / (t + 1 - lo).double()
        return s.t().to(x.dtype).contiguous()
    if agg == "max":
        out = x.clone()
        for j in range(1, w):
            out = torch.maximum(out, x[(t - j).clamp_min(0)])
        return out
    raise ValueError(f"unknown agg {agg!r}")
