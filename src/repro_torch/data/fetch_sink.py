# fmt: off
# A copy of src/repro/data/fetch_sink.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Big data/stream processing service components (paper §3.1, Fig. 2).

"A service consists of three key components, Buffer Manager, Fetch and
Sink, and OperatorLogic. The service logic is based on a scheduler that
ensures the recurrence rate in which the analytics operation implemented by
the service is executed. ... the service communicates asynchronously with
other micro-services using a message oriented middleware."

Components here:

  * :class:`MessageBroker` — the message-oriented middleware (RabbitMQ in
    the paper's deployment): named topics, per-subscriber FIFO queues.
  * :class:`Fetch` — subscribes to a topic and drains notified batches into
    the service's :class:`~repro.data.buffer.BufferManager`.
  * :class:`HistoricFetch` — "a one-shot query for retrieving stored data
    according to an input query" against a TimeSeriesStore.
  * :class:`Sink` — publishes operator results downstream.
  * :class:`StreamService` — the composed service: every ``period`` seconds
    of stream time it fetches, windows, applies its operator, and sinks.

Everything is synchronous & deterministic (driven by an explicit clock) so
the same services run inside the discrete-event simulator, the real
executor, and the tests.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.buffer import BufferManager
from repro_torch.data.stores import TimeSeriesStore
from repro_torch.data.streams import StreamBatch
from repro_torch.pipeline import windows as W


class MessageBroker:
    """Topic-based pub/sub with per-subscriber FIFO queues."""

    def __init__(self) -> None:
        self._queues: Dict[str, Dict[str, Deque[StreamBatch]]] = defaultdict(dict)
        self.published_bytes: Dict[str, int] = defaultdict(int)

    def subscribe(self, topic: str, subscriber: str) -> None:
        self._queues[topic].setdefault(subscriber, deque())

    def publish(self, topic: str, batch: StreamBatch) -> None:
        self.published_bytes[topic] += batch.nbytes
        for q in self._queues[topic].values():  # det: ok independent per-subscriber queues; order-free
            q.append(batch)

    def drain(self, topic: str, subscriber: str) -> List[StreamBatch]:
        q = self._queues[topic].get(subscriber)
        if not q:
            return []
        out = list(q)
        q.clear()
        return out


@dataclasses.dataclass
class Fetch:
    """Continuous consumption: drain the broker queue into the buffer."""

    broker: MessageBroker
    topic: str
    subscriber: str

    def __post_init__(self) -> None:
        self.broker.subscribe(self.topic, self.subscriber)

    def __call__(self, buffer: BufferManager) -> int:
        n = 0
        for batch in self.broker.drain(self.topic, self.subscriber):
            buffer.append(batch)
            n += len(batch)
        return n


@dataclasses.dataclass
class HistoricFetch:
    """One-shot temporal query against a (possibly remote) store."""

    store: TimeSeriesStore
    series: str

    def __call__(self, t_start: float, t_end: float) -> Optional[StreamBatch]:
        return self.store.query(self.series, t_start, t_end)


@dataclasses.dataclass
class Sink:
    """Publish results to a downstream topic (or collect locally)."""

    broker: Optional[MessageBroker] = None
    topic: str = "results"
    collected: List[Tuple[float, np.ndarray]] = dataclasses.field(default_factory=list)

    def __call__(self, t: float, result: np.ndarray) -> None:
        self.collected.append((t, np.asarray(result)))
        if self.broker is not None:
            batch = StreamBatch(np.asarray([t]),
                                np.asarray(result, np.float32).reshape(1, -1),
                                tuple(f"r{i}" for i in range(np.asarray(result).size)))
            self.broker.publish(self.topic, batch)


class StreamService:
    """The paper's Fig. 2 service: Fetch + BufferManager + OperatorLogic +
    Sink, executed at a recurrence ``period`` over a window of ``window``
    seconds, optionally fusing store history (HistoricFetch) with the live
    stream.

    Example (paper §3.4):  *"EVERY 60 seconds compute the max value of
    download_speed of the last 3 minutes FROM cassandra ... and streaming
    rabbitmq queue"* →  ``StreamService(period=60, window=180, agg="max",
    column="download_speed", historic=HistoricFetch(store, "speedtests"))``.
    """

    def __init__(self, name: str, fetch: Fetch, sink: Sink, *,
                 period: float, window: float, agg: str = "mean",
                 column: Optional[str] = None,
                 historic: Optional[HistoricFetch] = None,
                 landmark: Optional[float] = None,
                 buffer_capacity: int = 1 << 22,
                 spill_store: Optional[TimeSeriesStore] = None) -> None:
        if period <= 0 or window <= 0:
            raise ValueError("period/window must be positive")
        self.name = name
        self.fetch = fetch
        self.sink = sink
        self.period = period
        self.window = window
        self.agg = agg
        self.column = column
        self.historic = historic
        self.landmark = landmark
        self.buffer = BufferManager(buffer_capacity, spill_store=spill_store,
                                    series=f"{name}_spill")
        self._next_fire: Optional[float] = None
        self.fired = 0

    # -- operator logic ---------------------------------------------------------
    def _values(self, batch: StreamBatch) -> np.ndarray:
        if self.column is None:
            return batch.values
        return batch.column(self.column)[:, None]

    def _window_data(self, now: float) -> Optional[StreamBatch]:
        t0 = self.landmark if self.landmark is not None else now - self.window
        live = self.buffer.read_range(t0, now)
        if self.historic is None:
            return live
        hist = self.historic(t0, now)
        if hist is None:
            return live
        if live is None:
            return hist
        ts, vals = W.combine_history_and_live(hist.ts, hist.values,
                                              live.ts, live.values)
        return StreamBatch(ts, vals, hist.columns)

    def step(self, now: float) -> Optional[np.ndarray]:
        """Advance stream-time to ``now``; fire if the recurrence is due."""
        self.fetch(self.buffer)
        if self._next_fire is None:
            self._next_fire = now + self.period
            return None
        if now < self._next_fire:
            return None
        self._next_fire += self.period
        data = self._window_data(now)
        if data is None or len(data) == 0:
            return None
        vals = self._values(data)
        agg_fn = W.AGGS[self.agg]
        result = agg_fn(vals)
        self.sink(now, result)
        self.fired += 1
        return np.asarray(result)

    def run(self, clock: Sequence[float]) -> List[Tuple[float, np.ndarray]]:
        """Drive the service over explicit stream-time ticks."""
        for t in clock:
            self.step(float(t))
        return self.sink.collected
