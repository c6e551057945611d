"""The paper's DS operators with host (numpy) and device (torch) backends.

Paper §4: the compiler emits a *flexible binary* per task so the runtime can
invoke it on any processing element. Every operator has

  * a **host** backend — numpy, the edge side; the same arithmetic as the
    reference package's host backend;
  * a **device** backend — torch on the tensors' device (the VDC's card, or
    the CPU in the tests), written out per operator because torch's API is
    not numpy's;

with identical semantics, so the scheduler's placement never changes
results, only cost. The device k-means step calls the ``kmeans_assign``
kernel, and the device window aggregate and both rolling means of
``anomaly`` call the ``window_agg`` kernel.

All operators are shape-static (masks, not boolean filtering). Operator
catalogue: the 16 functions of the paper's DS workload (Fig. 5).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.kmeans.ops import kmeans_assign
from repro_torch.kernels.window_agg.ops import window_agg

# ---------------------------------------------------------------------------
# Host backend (numpy)
# ---------------------------------------------------------------------------


def _np_ingest(raw):
    """Parse raw sensor batch → float32 matrix (n_rows, n_cols)."""
    x = np.asarray(raw, dtype=np.float32)
    if x.ndim == 1:
        x = x[:, None]
    return x


def _np_sql_transform(x, *, scale=1.0, shift=0.0, clip_lo=-1e9, clip_hi=1e9):
    """Projection + scalar WHERE-style clamp (SELECT scale*c+shift ...)."""
    return np.clip(x * scale + shift, clip_lo, clip_hi)


def _np_clean_missing(x):
    """Replace NaN/inf by the column mean of finite entries."""
    finite = np.isfinite(x)
    safe = np.where(finite, x, 0.0)
    cnt = np.maximum(finite.sum(axis=0), 1).astype(x.dtype)
    mean = safe.sum(axis=0) / cnt
    return np.where(finite, x, mean[None, :])


def _np_select_columns(x, *, k=4):
    """Keep the k highest-variance columns (stable order by index)."""
    k = min(k, x.shape[1])
    idx = np.sort(np.argsort(-x.var(axis=0))[:k])
    return np.take(x, idx, axis=1)


def _np_summarize(x):
    """Per-column summary stats → (5, n_cols): mean, std, min, max, median."""
    med = np.quantile(x, 0.5, axis=0).astype(x.dtype)
    return np.stack([x.mean(axis=0), x.std(axis=0), x.min(axis=0), x.max(axis=0), med])


def _np_window_agg(x, *, window=8, agg="mean"):
    """Sliding-window aggregate along axis 0 (same-length, causal): rows
    [t-w+1, t] clamped at 0, by prefix sums (mean/sum) or a stack (max)."""
    n = x.shape[0]
    w = max(1, min(window, n))
    if agg in ("mean", "sum"):
        c = np.cumsum(x, axis=0)
        zeros = np.zeros((1,) + x.shape[1:], dtype=x.dtype)
        c = np.concatenate([zeros, c], axis=0)  # c[i] = sum of x[:i]
        lo = np.maximum(np.arange(n) - w + 1, 0)
        hi = np.arange(n) + 1
        s = np.take(c, hi, axis=0) - np.take(c, lo, axis=0)
        if agg == "sum":
            return s
        return s / (hi - lo).astype(x.dtype)[:, None]
    if agg == "max":
        xpad = np.pad(x, [(w - 1, 0)] + [(0, 0)] * (x.ndim - 1), mode="edge")
        return np.stack([xpad[i : i + n] for i in range(w)]).max(axis=0)
    raise ValueError(f"unknown agg {agg!r}")


def _np_anomaly(x, *, window=16, z=3.0):
    """Time-series anomaly flags: |x - rolling_mean| > z * rolling_std."""
    mu = _np_window_agg(x, window=window, agg="mean")
    sq = _np_window_agg(x * x, window=window, agg="mean")
    var = np.maximum(sq - mu * mu, 1e-12)
    return (np.abs(x - mu) > z * np.sqrt(var)).astype(x.dtype)


def _np_filter_features(x, *, k=4, target_col=0):
    """Filter-based feature selection: top-k |corr with target| columns."""
    y = x[:, target_col]
    xc = x - x.mean(axis=0, keepdims=True)
    yc = y - y.mean()
    cov = (xc * yc[:, None]).mean(axis=0)
    denom = np.sqrt(np.maximum(xc.var(axis=0) * yc.var(), 1e-12))
    corr = np.abs(cov / denom)
    corr[target_col] = -1.0  # never re-select the target itself
    k = min(k, x.shape[1] - 1)
    idx = np.sort(np.argsort(-corr)[:k])
    return np.take(x, idx, axis=1)


def _np_pca(x, *, k=2, iters=16):
    """Top-k PCA scores via subspace (orthogonal) iteration."""
    xc = x - x.mean(axis=0, keepdims=True)
    d = x.shape[1]
    k = min(k, d)
    cov = xc.T @ xc / max(x.shape[0] - 1, 1)
    q = np.eye(d, dtype=x.dtype)[:, :k]
    for _ in range(iters):
        q, _r = np.linalg.qr(cov @ q)
    sgn = np.sign(q[np.argmax(np.abs(q), axis=0), np.arange(k)])
    return xc @ (q * sgn[None, :])


def _np_kmeans_step(x, cent):
    d2 = ((x[:, None, :] - cent[None, :, :]) ** 2).sum(-1)  # (n, k)
    assign = np.argmin(d2, axis=1)
    onehot = (assign[:, None] == np.arange(cent.shape[0])[None, :]).astype(x.dtype)
    cnt = np.maximum(onehot.sum(0), 1.0)
    new = (onehot.T @ x) / cnt[:, None]
    new = np.where((onehot.sum(0) > 0)[:, None], new, cent)  # keep empty clusters
    return new, assign, d2


def _np_kmeans_init(x, k):
    """Deterministic spread init: evenly-spaced rows of the sorted-by-norm x."""
    n = x.shape[0]
    order = np.argsort((x * x).sum(-1))
    pick = np.take(order, (np.arange(k) * max(n // k, 1)) % n)
    return np.take(x, pick, axis=0)


def _np_train_cluster(x, cent, *, iters=20):
    """Lloyd iterations from given centroids → (centroids, assign, inertia)."""
    for _ in range(iters):
        cent, assign, d2 = _np_kmeans_step(x, cent)
    inertia = np.take_along_axis(d2, assign[:, None], axis=1).sum()
    return cent, assign, inertia


def _np_kmeans(x, *, k=4, iters=10):
    """Lloyd's k-means; returns (centroids, assignments, inertia)."""
    return _np_train_cluster(x, _np_kmeans_init(x, k), iters=iters)


def _np_sweep_clustering(x, *, ks=(2, 3, 4, 6), iters=10, penalty=0.05):
    """Parameter sweep over k; pick argmin(inertia/n + penalty·k·var)."""
    best = None
    for k in ks:
        cent, assign, inertia = _np_kmeans(x, k=k, iters=iters)
        score = float(inertia / x.shape[0] + penalty * k * float(x.var()))
        if best is None or score < best[0]:
            best = (score, cent, assign, k)
    return best[1:]


def _np_linreg(x, *, target_col=0, ridge=1e-6):
    """Ridge least-squares of target_col on the rest → (w, b)."""
    d = x.shape[1]
    y = x[:, target_col]
    feats = x[:, np.arange(d)[np.arange(d) != target_col]]
    xm = feats.mean(axis=0, keepdims=True)
    ym = y.mean()
    xc = feats - xm
    yc = y - ym
    gram = xc.T @ xc + ridge * np.eye(d - 1, dtype=x.dtype)
    w = np.linalg.solve(gram, xc.T @ yc)
    return w, ym - (xm[0] * w).sum()


def _np_score(x, w, b, *, target_col=0):
    """Apply a linreg model; return (pred, mse, r2)."""
    d = x.shape[1]
    feats = x[:, np.arange(d)[np.arange(d) != target_col]]
    y = x[:, target_col]
    pred = feats @ w + b
    err = pred - y
    mse = (err * err).mean()
    denom = np.maximum(((y - y.mean()) ** 2).mean(), 1e-12)
    return pred, mse, 1.0 - mse / denom


def _np_join(*parts):
    """Concatenate result tables column-wise after row-broadcasting."""
    parts = [np.asarray(p, dtype=np.float32) for p in parts]
    parts = [p[:, None] if p.ndim == 1 else p for p in parts]
    n = max(p.shape[0] for p in parts)
    out = []
    for p in parts:
        if p.shape[0] != n:  # tile summaries up to the longest table
            p = np.concatenate([p] * -(-n // p.shape[0]), axis=0)[:n]
        out.append(p)
    return np.concatenate(out, axis=1)


def _np_export(x):
    """Terminal digest: (count, mean, l2)."""
    return np.stack(
        [
            np.asarray(x.size, dtype=np.float32),
            x.mean().astype(np.float32),
            np.sqrt((x * x).sum()).astype(np.float32),
        ]
    )


# ---------------------------------------------------------------------------
# Device backend (torch). numpy and the JAX reference compute var/std with
# ddof 0, torch with correction 1 unless told: every call passes
# correction=0. Float32 matmuls stay in full float32 (torch's default,
# torch.backends.cuda.matmul.allow_tf32 False).
# ---------------------------------------------------------------------------


def _ingest(raw: torch.Tensor) -> torch.Tensor:
    x = raw.to(torch.float32)
    return x[:, None] if x.dim() == 1 else x


def _sql_transform(x, *, scale=1.0, shift=0.0, clip_lo=-1e9, clip_hi=1e9):
    return torch.clamp(x * scale + shift, clip_lo, clip_hi)


def _clean_missing(x):
    finite = torch.isfinite(x)
    safe = torch.where(finite, x, torch.zeros_like(x))
    cnt = finite.sum(0).clamp_min(1).to(x.dtype)
    return torch.where(finite, x, (safe.sum(0) / cnt)[None, :])


def _top_columns(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ascending (argsort is stable, as
    ``jnp.argsort``)."""
    return torch.sort(torch.argsort(-score, stable=True)[:k]).values


def _select_columns(x, *, k=4):
    k = min(k, x.shape[1])
    return x[:, _top_columns(x.var(0, correction=0), k)]


def _median(x: torch.Tensor) -> torch.Tensor:
    """Column median with numpy's default linear interpolation (its form
    ``b - (b - a) * 0.5`` between the two middle values), by sorting:
    ``torch.quantile`` refuses inputs above 2**24 elements."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    lo, hi = (n - 1) // 2, n // 2
    return s[hi] - (s[hi] - s[lo]) * 0.5 if hi != lo else s[lo]


def _summarize(x):
    return torch.stack(
        [x.mean(0), x.std(0, correction=0), x.amin(0), x.amax(0), _median(x)]
    )


def _window_agg(x, *, window=8, agg="mean"):
    return window_agg(x, window=window, agg=agg)


def _anomaly(x, *, window=16, z=3.0):
    mu = window_agg(x, window=window, agg="mean")
    sq = window_agg(x * x, window=window, agg="mean")
    var = (sq - mu * mu).clamp_min(1e-12)
    return (torch.abs(x - mu) > z * torch.sqrt(var)).to(x.dtype)


def _filter_features(x, *, k=4, target_col=0):
    y = x[:, target_col]
    xc = x - x.mean(0, keepdim=True)
    yc = y - y.mean()
    cov = (xc * yc[:, None]).mean(0)
    denom = torch.sqrt(
        (xc.var(0, correction=0) * yc.var(correction=0)).clamp_min(1e-12)
    )
    corr = torch.abs(cov / denom)
    corr[target_col] = -1.0  # never re-select the target itself
    return x[:, _top_columns(corr, min(k, x.shape[1] - 1))]


def _pca(x, *, k=2, iters=16):
    xc = x - x.mean(0, keepdim=True)
    d = x.shape[1]
    k = min(k, d)
    cov = xc.T @ xc / max(x.shape[0] - 1, 1)
    q = torch.eye(d, dtype=x.dtype, device=x.device)[:, :k]
    for _ in range(iters):
        q, _r = torch.linalg.qr(cov @ q)
    # sign-fix each component: QR's signs differ between libraries
    sgn = torch.sign(q[torch.argmax(torch.abs(q), 0), torch.arange(k, device=x.device)])
    return xc @ (q * sgn[None, :])


def _kmeans_step(x, cent):
    """One Lloyd step → (new centroids, assign, min_d2).

    The centroid update is a one-hot matmul, not ``index_add_``: atomics
    would sum in an order that changes from run to run."""
    assign, min_d2 = kmeans_assign(x, cent)
    ids = torch.arange(cent.shape[0], device=x.device, dtype=assign.dtype)
    onehot = (assign[:, None] == ids[None, :]).to(x.dtype)
    cnt = onehot.sum(0)
    new = (onehot.T @ x) / cnt.clamp_min(1.0)[:, None]
    new = torch.where((cnt > 0)[:, None], new, cent)  # keep empty clusters
    return new, assign, min_d2


def _kmeans_init(x, k):
    n = x.shape[0]
    order = torch.argsort((x * x).sum(-1), stable=True)
    pick = order[(torch.arange(k, device=x.device) * max(n // k, 1)) % n]
    return x[pick]


def _train_cluster(x, cent, *, iters=20):
    for _ in range(iters):
        cent, assign, min_d2 = _kmeans_step(x, cent)
    return cent, assign, min_d2.sum()


def _kmeans(x, *, k=4, iters=10):
    return _train_cluster(x, _kmeans_init(x, k), iters=iters)


def _sweep_clustering(x, *, ks=(2, 3, 4, 6), iters=10, penalty=0.05):
    best = None
    for k in ks:
        cent, assign, inertia = _kmeans(x, k=k, iters=iters)
        # the selection is Python-side on both backends: one sync per k
        score = float(inertia / x.shape[0] + penalty * k * float(x.var(correction=0)))
        if best is None or score < best[0]:
            best = (score, cent, assign, k)
    return best[1:]


def _feature_index(d: int, target_col: int, device) -> torch.Tensor:
    return torch.tensor([j for j in range(d) if j != target_col], device=device)


def _linreg(x, *, target_col=0, ridge=1e-6):
    d = x.shape[1]
    y = x[:, target_col]
    feats = x[:, _feature_index(d, target_col, x.device)]
    xm = feats.mean(0, keepdim=True)
    ym = y.mean()
    xc = feats - xm
    yc = y - ym
    gram = xc.T @ xc + ridge * torch.eye(d - 1, dtype=x.dtype, device=x.device)
    w = torch.linalg.solve(gram, xc.T @ yc)
    return w, ym - (xm[0] * w).sum()


def _score(x, w, b, *, target_col=0):
    feats = x[:, _feature_index(x.shape[1], target_col, x.device)]
    y = x[:, target_col]
    pred = feats @ w + b
    err = pred - y
    mse = (err * err).mean()
    denom = ((y - y.mean()) ** 2).mean().clamp_min(1e-12)
    return pred, mse, 1.0 - mse / denom


def _join(*parts):
    parts = [p.to(torch.float32) for p in parts]
    parts = [p[:, None] if p.dim() == 1 else p for p in parts]
    n = max(p.shape[0] for p in parts)
    out = []
    for p in parts:
        if p.shape[0] != n:  # tile summaries up to the longest table
            p = p.repeat(-(-n // p.shape[0]), 1)[:n]
        out.append(p)
    return torch.cat(out, dim=1)


def _export(x):
    return torch.stack(
        [
            torch.tensor(float(x.numel()), dtype=torch.float32, device=x.device),
            x.mean().to(torch.float32),
            torch.sqrt((x * x).sum()).to(torch.float32),
        ]
    )


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

_HOST: Dict[str, Callable] = {
    "ingest": _np_ingest,
    "sql_transform": _np_sql_transform,
    "clean_missing": _np_clean_missing,
    "select_columns": _np_select_columns,
    "summarize": _np_summarize,
    "window_agg": _np_window_agg,
    "anomaly": _np_anomaly,
    "filter_features": _np_filter_features,
    "pca": _np_pca,
    "kmeans": _np_kmeans,
    "sweep_clustering": _np_sweep_clustering,
    "train_cluster": _np_train_cluster,
    "linreg": _np_linreg,
    "score": _np_score,
    "join": _np_join,
    "export": _np_export,
}

_DEVICE: Dict[str, Callable] = {
    "ingest": _ingest,
    "sql_transform": _sql_transform,
    "clean_missing": _clean_missing,
    "select_columns": _select_columns,
    "summarize": _summarize,
    "window_agg": _window_agg,
    "anomaly": _anomaly,
    "filter_features": _filter_features,
    "pca": _pca,
    "kmeans": _kmeans,
    "sweep_clustering": _sweep_clustering,
    "train_cluster": _train_cluster,
    "linreg": _linreg,
    "score": _score,
    "join": _join,
    "export": _export,
}

OPERATORS: Tuple[str, ...] = tuple(_HOST)


def host_backend(op: str) -> Callable:
    """Host (numpy) implementation of ``op``."""
    return _HOST[op]


def device_backend(op: str) -> Callable:
    """Device (torch) implementation of ``op``; runs on its inputs' device."""
    return _DEVICE[op]


def backends(op: str) -> Dict[str, Callable]:
    """Both backends for a Task's ``backends`` field (the flexible binary)."""
    return {"host": host_backend(op), "device": device_backend(op)}
