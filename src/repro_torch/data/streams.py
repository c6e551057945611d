# fmt: off
# A copy of src/repro/data/streams.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Timestamped tuple streams (paper §3.1, stream exchange model).

"Services adopt the tuple oriented data model ... a stream is represented
as a series of attribute value couples where values are of atomic types
(integer, string, char, float). We assume that one of the attributes of the
tuple corresponds to its time-stamp."

A :class:`StreamBatch` is a columnar block of such tuples: a float64 ``ts``
vector plus a float32 value matrix with named columns — the exchange unit
between producers (IoT farm / Neubot probes), the message broker, and the
services. Generators below are deterministic given a seed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class StreamBatch:
    """Columnar batch of timestamped tuples."""

    ts: np.ndarray                 # (n,) float64, ascending
    values: np.ndarray             # (n, n_cols) float32
    columns: Tuple[str, ...]       # column names

    def __post_init__(self) -> None:
        self.ts = np.asarray(self.ts, dtype=np.float64)
        self.values = np.asarray(self.values, dtype=np.float32)
        if self.values.ndim == 1:
            self.values = self.values[:, None]
        if len(self.ts) != len(self.values):
            raise ValueError("ts/values length mismatch")
        if len(self.columns) != self.values.shape[1]:
            raise ValueError("column count mismatch")

    def __len__(self) -> int:
        return len(self.ts)

    @property
    def nbytes(self) -> int:
        return self.ts.nbytes + self.values.nbytes

    def column(self, name: str) -> np.ndarray:
        return self.values[:, self.columns.index(name)]

    def concat(self, other: "StreamBatch") -> "StreamBatch":
        if self.columns != other.columns:
            raise ValueError("schema mismatch")
        return StreamBatch(np.concatenate([self.ts, other.ts]),
                           np.concatenate([self.values, other.values]),
                           self.columns)

    def slice(self, lo: int, hi: int) -> "StreamBatch":
        return StreamBatch(self.ts[lo:hi], self.values[lo:hi], self.columns)

    @staticmethod
    def empty(columns: Sequence[str]) -> "StreamBatch":
        return StreamBatch(np.zeros(0), np.zeros((0, len(columns)), np.float32),
                           tuple(columns))


def synthetic_stream(n: int, n_cols: int = 4, rate_hz: float = 10.0,
                     seed: int = 0, t0: float = 0.0,
                     columns: Optional[Sequence[str]] = None) -> StreamBatch:
    """Generic IoT-farm stream: jittered arrivals, AR(1)-ish channels."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=n)
    ts = t0 + np.cumsum(gaps)
    x = np.zeros((n, n_cols), np.float32)
    drift = rng.normal(0, 1, size=n_cols).astype(np.float32)
    prev = rng.normal(0, 1, size=n_cols).astype(np.float32)
    noise = rng.normal(0, 0.5, size=(n, n_cols)).astype(np.float32)
    for i in range(n):
        prev = 0.95 * prev + noise[i] + 0.01 * drift
        x[i] = prev
    cols = tuple(columns) if columns else tuple(f"c{i}" for i in range(n_cols))
    return StreamBatch(ts, x, cols)


NEUBOT_COLUMNS = ("download_speed", "upload_speed", "latency", "provider_id")


class NeubotStream:
    """Neubot-style network-test stream (paper §3.4 use case).

    Probes measure download/upload speed (Mbps), latency (ms) and carry a
    provider id; diurnal modulation makes the paper's example queries
    ("periods of the day with highest speed") meaningful.
    """

    def __init__(self, n_providers: int = 3, rate_hz: float = 1.0,
                 seed: int = 0) -> None:
        self.n_providers = n_providers
        self.rate_hz = rate_hz
        self.seed = seed
        self._base_down = 20.0 + 30.0 * np.random.default_rng(seed).random(n_providers)
        self._base_up = self._base_down * 0.25

    def batch(self, n: int, t0: float = 0.0) -> StreamBatch:
        rng = np.random.default_rng(self.seed + int(t0 * 1000) % (2 ** 31))
        gaps = rng.exponential(1.0 / self.rate_hz, size=n)
        ts = t0 + np.cumsum(gaps)
        prov = rng.integers(0, self.n_providers, size=n)
        # diurnal factor: slow in the evening peak (18-23h), fast at night
        hour = (ts / 3600.0) % 24.0
        diurnal = 1.0 - 0.4 * np.exp(-0.5 * ((hour - 20.5) / 2.0) ** 2)
        down = self._base_down[prov] * diurnal * rng.lognormal(0, 0.15, n)
        up = self._base_up[prov] * diurnal * rng.lognormal(0, 0.2, n)
        lat = 20.0 / diurnal * rng.lognormal(0, 0.3, n)
        vals = np.stack([down, up, lat, prov.astype(np.float64)], axis=1)
        return StreamBatch(ts, vals.astype(np.float32), NEUBOT_COLUMNS)

    def stream(self, batch_size: int, n_batches: int,
               t0: float = 0.0) -> Iterator[StreamBatch]:
        t = t0
        for _ in range(n_batches):
            b = self.batch(batch_size, t0=t)
            t = float(b.ts[-1]) + 1e-6
            yield b
