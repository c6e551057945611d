"""The port's data layer (``repro_torch.data``, ``repro_torch.pipeline.windows``)
against the JAX package's: each module a copy of its reference (imports
renamed), ``tests/test_data.py`` case for case on the port, and the LM
loader's batches byte-equal to the reference's."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.data import loader as ref_loader
from repro.pipeline import windows as ref_windows
from repro_torch.data import (BufferManager, Fetch, HistoricFetch, KVStore,
                              MessageBroker, NeubotStream, Sink, StreamService,
                              TimeSeriesStore)
from repro_torch.data import loader as port_loader
from repro_torch.data.streams import StreamBatch, synthetic_stream
from repro_torch.data.loader import LoaderConfig, Prefetcher, TokenBatchLoader
from repro_torch.pipeline import windows as port_windows

SRC = Path(__file__).resolve().parent.parent / "src"
_IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)
COPIED = ["pipeline/windows.py", "data/__init__.py", "data/streams.py",
          "data/stores.py", "data/buffer.py", "data/fetch_sink.py",
          "data/loader.py", "train/fault_tolerance.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_equal_their_reference(rel):
    """Each copy is its reference module with the three-line header on top
    and ``repro.`` renamed to ``repro_torch.`` in import lines only."""
    ref = (SRC / "repro" / rel).read_text()
    header = (f"# fmt: off\n# A copy of src/repro/{rel}, kept in its hand-aligned "
              "layout so the\n# two stay diffable line for line; only the imports "
              "name repro_torch.\n")
    renamed = _IMPORT.sub(lambda m: f"{m.group(1)}{m.group(2)} repro_torch.", ref)
    assert (SRC / "repro_torch" / rel).read_text() == header + renamed


@pytest.mark.parametrize("name", ["synthetic_documents", "hash_tokenize",
                                  "LoaderConfig", "TokenBatchLoader",
                                  "Prefetcher"])
def test_loader_sources_equal_their_reference(name):
    assert (inspect.getsource(getattr(port_loader, name))
            == inspect.getsource(getattr(ref_loader, name)))


# -- tests/test_data.py, case for case ------------------------------------------

def test_stream_batch_schema_checks():
    with pytest.raises(ValueError):
        StreamBatch(np.zeros(3), np.zeros((2, 2), np.float32), ("a", "b"))
    with pytest.raises(ValueError):
        StreamBatch(np.zeros(2), np.zeros((2, 2), np.float32), ("a",))


def test_timeseries_store_range_query():
    store = TimeSeriesStore()
    b1 = synthetic_stream(50, seed=1)
    b2 = synthetic_stream(50, seed=2, t0=float(b1.ts[-1]) + 1)
    store.write("s", b1)
    store.write("s", b2)
    lo, hi = float(b1.ts[10]), float(b2.ts[5])
    out = store.query("s", lo, hi)
    assert out is not None
    assert (out.ts >= lo).all() and (out.ts < hi).all()
    assert len(out) == 40 + 5        # rows 10..49 of b1 + rows 0..4 of b2


def test_timeseries_store_rejects_out_of_order():
    store = TimeSeriesStore()
    store.write("s", synthetic_stream(10, seed=1, t0=100.0))
    with pytest.raises(ValueError):
        store.write("s", synthetic_stream(10, seed=2, t0=0.0))


def test_kvstore_roundtrip_arrays():
    kv = KVStore()
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    kv.put_array("a/b", arr)
    np.testing.assert_array_equal(kv.get_array("a/b"), arr)
    assert kv.scan("a/") == ["a/b"]
    assert kv.get("missing") is None


@settings(max_examples=20, deadline=None)
@given(cap_kb=st.integers(2, 64), n_batches=st.integers(1, 12))
def test_buffer_never_loses_rows_with_spill(cap_kb, n_batches):
    spill = TimeSeriesStore()
    bm = BufferManager(capacity_bytes=cap_kb * 1024, spill_store=spill)
    total = 0
    t0 = 0.0
    for i in range(n_batches):
        b = synthetic_stream(40, seed=i, t0=t0)
        t0 = float(b.ts[-1]) + 1e-3
        bm.append(b)
        total += len(b)
    assert bm.stats.dropped_rows == 0
    merged = bm.read_range(0.0, 1e12)
    assert merged is not None and len(merged) == total
    assert (np.diff(merged.ts) >= 0).all()


def test_stream_service_neubot_query():
    """Paper §3.4 query 1: EVERY 60 s max(download_speed) of last 3 min."""
    broker = MessageBroker()
    src = NeubotStream(rate_hz=2.0, seed=3)
    svc = StreamService("q1", Fetch(broker, "neubotspeed", "q1"), Sink(),
                        period=60, window=180, agg="max",
                        column="download_speed")
    t = 0.0
    for batch in src.stream(batch_size=100, n_batches=12):
        broker.publish("neubotspeed", batch)
        t = float(batch.ts[-1])
        svc.step(t)
    assert svc.fired >= 6
    for _, result in svc.sink.collected:
        assert result > 0


def test_stream_service_fuses_history():
    """HistoricFetch + live stream fusion (paper §3.2)."""
    broker = MessageBroker()
    store = TimeSeriesStore()
    hist = synthetic_stream(200, seed=9)          # history: t ∈ [0, ~20]
    store.write("speedtests", hist)
    t_live = float(hist.ts[-1]) + 0.01
    svc = StreamService("q2", Fetch(broker, "live", "q2"), Sink(),
                        period=5.0, window=1e9, agg="count",
                        historic=HistoricFetch(store, "speedtests"),
                        landmark=0.0)
    live = synthetic_stream(50, seed=10, t0=t_live)
    broker.publish("live", live)
    svc.step(t_live)                               # arm the recurrence
    svc.step(float(live.ts[-1]) + 10.0)
    assert svc.fired == 1
    count = float(svc.sink.collected[-1][1])
    assert count == len(hist) + len(live)


def test_loader_packs_fixed_blocks():
    ld = TokenBatchLoader(LoaderConfig(batch_size=4, seq_len=32,
                                       vocab_size=1000, n_docs=64))
    b = next(iter(ld))
    assert b["tokens"].shape == (4, 32) and b["labels"].shape == (4, 32)
    # labels are next-token shifted within the packed block
    ld2 = TokenBatchLoader(LoaderConfig(batch_size=4, seq_len=32,
                                        vocab_size=1000, n_docs=64))
    b2 = next(iter(ld2))
    np.testing.assert_array_equal(b["tokens"][:, 1:], b2["labels"][:, :-1])
    assert (b["tokens"] >= 1).all() and (b["tokens"] < 1000).all()


def test_prefetcher_preserves_order_and_propagates_errors():
    pf = Prefetcher(iter(range(10)))
    assert list(pf) == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("io error")
    pf = Prefetcher(boom())
    assert next(pf) == 1
    with pytest.raises(RuntimeError):
        list(pf)


# -- against the live reference ---------------------------------------------------

LOADERS = [dict(batch_size=4, seq_len=32, vocab_size=1000, n_docs=64),
           dict(batch_size=8, seq_len=128, vocab_size=512, n_docs=256, seed=3),
           dict(batch_size=8, seq_len=1024, vocab_size=151936, n_docs=256)]


@pytest.mark.parametrize("kw", LOADERS, ids=["small", "smoke", "qwen3-train"])
def test_loader_batches_byte_equal_to_reference(kw):
    """Every batch of an epoch and the wrap into the next: same dtypes,
    shapes and bytes (phase 10's loader is the last case)."""
    ref = ref_loader.TokenBatchLoader(ref_loader.LoaderConfig(**kw))
    port = TokenBatchLoader(LoaderConfig(**kw))
    n = len(port._flat) // (kw["batch_size"] * (kw["seq_len"] + 1)) + 2
    assert n > 2
    for _ in range(n):
        want, got = next(ref), next(port)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("vocab", [3, 512, 32768, 151936])
def test_documents_and_tokens_equal_reference(vocab):
    docs = list(port_loader.synthetic_documents(6, mean_len=40, seed=vocab))
    assert docs == list(ref_loader.synthetic_documents(6, mean_len=40, seed=vocab))
    for d in docs:
        got = port_loader.hash_tokenize(d, vocab)
        want = ref_loader.hash_tokenize(d, vocab)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _windows(W, agg):
    ts = np.cumsum(np.random.default_rng(4).exponential(0.5, 257))
    x = np.random.default_rng(5).normal(0, 1, (257, 3)).astype(np.float32)
    out = []
    for bounds in (W.tumbling(ts, 7.0), W.sliding(ts, 10.0, 3.0),
                   W.landmark(ts, float(ts[20]), 12.5)):
        ends, vals = W.aggregate(x, ts, bounds, agg)
        out.append(([(b.start, b.end, b.lo, b.hi, b.n_rows) for b in bounds],
                    ends.tobytes(), np.asarray(vals).tobytes()))
    hts, hv = W.combine_history_and_live(ts[:150], x[:150], ts[120:], x[120:])
    out.append((hts.tobytes(), hv.tobytes()))
    return out


@pytest.mark.parametrize("agg", sorted(ref_windows.AGGS))
def test_windows_equal_reference(agg):
    """Tumbling, sliding and landmark bounds, their aggregates and the
    history/live fusion: equal to the reference's, bytes and all."""
    assert _windows(port_windows, agg) == _windows(ref_windows, agg)
