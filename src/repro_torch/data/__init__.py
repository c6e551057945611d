# fmt: off
# A copy of src/repro/data/__init__.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""repro.data — streams, buffers, stores, and service plumbing (paper §3.1–3.2)."""

from repro_torch.data.streams import StreamBatch, NeubotStream, synthetic_stream
from repro_torch.data.buffer import BufferManager
from repro_torch.data.stores import TimeSeriesStore, KVStore
from repro_torch.data.fetch_sink import Fetch, HistoricFetch, Sink, StreamService, MessageBroker

__all__ = [
    "StreamBatch", "NeubotStream", "synthetic_stream",
    "BufferManager", "TimeSeriesStore", "KVStore",
    "Fetch", "HistoricFetch", "Sink", "StreamService", "MessageBroker",
]
