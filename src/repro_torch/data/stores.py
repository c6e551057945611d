# fmt: off
# A copy of src/repro/data/stores.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Interval-oriented stores (paper §3.2).

The paper's HistoricFetch talks to two stores "distributedly installed on
the edge and on the VDC":

  * **InfluxDB** — "a time series system accepting temporal queries, useful
    for computing time tagged tuples"  → :class:`TimeSeriesStore`;
  * **Cassandra** — "a key-value store that provides non-temporal
    read/write operations ... for storing huge quantities of data"
    → :class:`KVStore`.

Both are in-process, deterministic, and track I/O byte counters so the
JITA-4DS cost model can price store access like any other transfer. A
``location`` tag ("frontend" / "backend") records where the store instance
lives, used by the executor when charging cross-location reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.streams import StreamBatch


@dataclasses.dataclass
class StoreStats:
    writes: int = 0
    reads: int = 0
    bytes_written: int = 0
    bytes_read: int = 0


class TimeSeriesStore:
    """InfluxDB-like: append-only series with [t0, t1) range queries."""

    def __init__(self, location: str = "backend") -> None:
        self.location = location
        self._series: Dict[str, List[StreamBatch]] = {}
        self.stats = StoreStats()

    def write(self, series: str, batch: StreamBatch) -> None:
        blocks = self._series.setdefault(series, [])
        if blocks and len(batch) and batch.ts[0] < blocks[-1].ts[-1]:
            raise ValueError("out-of-order append to time series")
        blocks.append(batch)
        self.stats.writes += 1
        self.stats.bytes_written += batch.nbytes

    def query(self, series: str, t_start: float, t_end: float
              ) -> Optional[StreamBatch]:
        """All tuples with t_start <= ts < t_end (one-shot temporal query)."""
        blocks = self._series.get(series)
        if not blocks:
            return None
        parts: List[StreamBatch] = []
        for b in blocks:
            if len(b) == 0 or b.ts[-1] < t_start or b.ts[0] >= t_end:
                continue
            lo = int(np.searchsorted(b.ts, t_start, side="left"))
            hi = int(np.searchsorted(b.ts, t_end, side="left"))
            if hi > lo:
                parts.append(b.slice(lo, hi))
        if not parts:
            return None
        out = parts[0]
        for p in parts[1:]:
            out = out.concat(p)
        self.stats.reads += 1
        self.stats.bytes_read += out.nbytes
        return out

    def series_range(self, series: str) -> Optional[Tuple[float, float]]:
        blocks = self._series.get(series)
        if not blocks:
            return None
        return float(blocks[0].ts[0]), float(blocks[-1].ts[-1])

    def nbytes(self, series: Optional[str] = None) -> int:
        names = [series] if series else list(self._series)
        return sum(b.nbytes for n in names for b in self._series.get(n, []))


class KVStore:
    """Cassandra-like key-value store: non-temporal put/get/scan."""

    def __init__(self, location: str = "backend") -> None:
        self.location = location
        self._data: Dict[str, bytes] = {}
        self.stats = StoreStats()

    def put(self, key: str, value: bytes) -> None:
        if not isinstance(value, (bytes, bytearray)):
            raise TypeError("KVStore values are bytes")
        self._data[key] = bytes(value)
        self.stats.writes += 1
        self.stats.bytes_written += len(value)

    def get(self, key: str) -> Optional[bytes]:
        v = self._data.get(key)
        if v is not None:
            self.stats.reads += 1
            self.stats.bytes_read += len(v)
        return v

    def delete(self, key: str) -> bool:
        return self._data.pop(key, None) is not None

    def scan(self, prefix: str = "") -> List[str]:
        return sorted(k for k in self._data if k.startswith(prefix))

    def put_array(self, key: str, arr: np.ndarray) -> None:
        import io
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        self.put(key, buf.getvalue())

    def get_array(self, key: str) -> Optional[np.ndarray]:
        import io
        v = self.get(key)
        if v is None:
            return None
        return np.load(io.BytesIO(v), allow_pickle=False)

    def __len__(self) -> int:
        return len(self._data)
