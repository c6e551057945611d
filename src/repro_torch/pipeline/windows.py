# fmt: off
# A copy of src/repro/pipeline/windows.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Window strategies over timestamped streams (paper §3.1).

The paper's stream services process data "on-line using tree window based
strategies [17, 19] (tumbling, sliding and landmark) well known in the
stream processing systems domain", combinable with stream histories
("the average number of connections ... of the last month until the next
hour").

A window strategy maps a timestamped tuple table → a list of (window_start,
window_end, row_slice) index bounds; aggregation over a window is then a
plain reduction (host numpy or device jnp — see
:func:`repro.pipeline.operators._window_agg` for the fused device path).

Timestamps are float seconds, ascending (the paper: "the time-stamp
represents the time of arrival of the stream to the communication
infrastructure"); all functions are pure and deterministic.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class WindowBounds:
    """Half-open time window [start, end) with row index bounds [lo, hi)."""

    start: float
    end: float
    lo: int
    hi: int

    @property
    def n_rows(self) -> int:
        return self.hi - self.lo


def _row_bounds(ts: np.ndarray, start: float, end: float) -> Tuple[int, int]:
    lo = int(np.searchsorted(ts, start, side="left"))
    hi = int(np.searchsorted(ts, end, side="left"))
    return lo, hi


def tumbling(ts: np.ndarray, size: float,
             origin: Optional[float] = None) -> List[WindowBounds]:
    """Non-overlapping contiguous windows of ``size`` seconds."""
    if len(ts) == 0:
        return []
    if size <= 0:
        raise ValueError("window size must be positive")
    t0 = float(ts[0]) if origin is None else origin
    t_end = float(ts[-1])
    out: List[WindowBounds] = []
    start = t0
    while start <= t_end:
        end = start + size
        lo, hi = _row_bounds(ts, start, end)
        out.append(WindowBounds(start, end, lo, hi))
        start = end
    return out


def sliding(ts: np.ndarray, size: float, step: float,
            origin: Optional[float] = None) -> List[WindowBounds]:
    """Overlapping windows of ``size`` seconds advancing by ``step``.

    ``step == size`` degenerates to tumbling (property-tested).
    """
    if len(ts) == 0:
        return []
    if size <= 0 or step <= 0:
        raise ValueError("size and step must be positive")
    t0 = float(ts[0]) if origin is None else origin
    t_end = float(ts[-1])
    out: List[WindowBounds] = []
    start = t0
    while start <= t_end:
        end = start + size
        lo, hi = _row_bounds(ts, start, end)
        out.append(WindowBounds(start, end, lo, hi))
        start += step
    return out


def landmark(ts: np.ndarray, landmark_t: float, step: float) -> List[WindowBounds]:
    """Growing windows from a fixed landmark to each step boundary.

    The paper's "starting 10 days ago" queries: every window starts at the
    landmark; the end advances by ``step``.
    """
    if len(ts) == 0:
        return []
    if step <= 0:
        raise ValueError("step must be positive")
    t_end = float(ts[-1])
    out: List[WindowBounds] = []
    end = landmark_t + step
    while end <= t_end + step:
        lo, hi = _row_bounds(ts, landmark_t, end)
        out.append(WindowBounds(landmark_t, end, lo, hi))
        end += step
    return out


# ---------------------------------------------------------------------------
# Windowed aggregation (host path; device path fuses via operators.window_agg)
# ---------------------------------------------------------------------------

AGGS: dict = {
    "mean": lambda x: x.mean(axis=0) if len(x) else np.zeros(x.shape[1:], x.dtype),
    "sum": lambda x: x.sum(axis=0),
    "max": lambda x: x.max(axis=0) if len(x) else np.full(x.shape[1:], -np.inf, x.dtype),
    "min": lambda x: x.min(axis=0) if len(x) else np.full(x.shape[1:], np.inf, x.dtype),
    "count": lambda x: np.asarray(float(len(x)), dtype=np.float32),
}


def aggregate(values: np.ndarray, ts: np.ndarray,
              bounds: Sequence[WindowBounds], agg: str = "mean"
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Aggregate ``values`` per window → (window_end_ts, aggregates)."""
    fn = AGGS[agg]
    outs = [fn(values[b.lo:b.hi]) for b in bounds]
    ends = np.asarray([b.end for b in bounds], dtype=np.float64)
    return ends, np.stack(outs) if outs else np.zeros((0,) + values.shape[1:], values.dtype)


def combine_history_and_live(hist_ts: np.ndarray, hist_vals: np.ndarray,
                             live_ts: np.ndarray, live_vals: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse a stored history with the live stream (paper §3.2: HistoricFetch
    + Fetch feeding one window operator). De-duplicates the overlap by
    preferring live tuples at equal timestamps."""
    if len(hist_ts) == 0:
        return live_ts, live_vals
    if len(live_ts) == 0:
        return hist_ts, hist_vals
    cut = bisect.bisect_left(list(hist_ts), float(live_ts[0]))
    ts = np.concatenate([hist_ts[:cut], live_ts])
    vals = np.concatenate([hist_vals[:cut], live_vals])
    return ts, vals
