# fmt: off
# A copy of src/repro/data/loader.py, kept in its hand-aligned layout so the
# two stay diffable line for line; only the imports name repro_torch.
"""Host-side token pipeline for LM training (the "edge" of a pod worker).

In JITA-4DS terms the training data pipeline is an edge-resident DS
pipeline: ingest → tokenize → pack → (device) train step. This module is
the host half: a deterministic synthetic corpus, a hash tokenizer, fixed
(batch, seq) packing, and a double-buffered prefetcher so host work overlaps
device steps (the paper's frontend/backend overlap, at PCIe scale).

Real deployments swap :func:`synthetic_documents` for a file/GCS reader;
everything downstream is unchanged.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

_WORDS = np.array([
    "the", "of", "and", "to", "in", "a", "is", "that", "for", "it", "as",
    "was", "with", "be", "by", "on", "not", "he", "i", "this", "are", "or",
    "his", "from", "at", "which", "but", "have", "an", "had", "they", "you",
    "were", "their", "one", "all", "we", "can", "her", "has", "there",
    "been", "if", "more", "when", "will", "would", "who", "so", "no",
    "data", "stream", "edge", "pipeline", "model", "cluster", "service",
    "window", "tensor", "gradient", "neubot", "download", "upload", "speed",
])


def synthetic_documents(n_docs: int, mean_len: int = 256,
                        seed: int = 0) -> Iterator[str]:
    """Deterministic Zipf-ish word soup documents."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(_WORDS) + 1)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    for _ in range(n_docs):
        n = max(8, int(rng.normal(mean_len, mean_len // 4)))
        words = rng.choice(_WORDS, size=n, p=probs)
        yield " ".join(words.tolist())


def hash_tokenize(text: str, vocab_size: int) -> np.ndarray:
    """Stateless word→id tokenizer (FNV-1a hash mod vocab, ids ≥ 2).

    ids 0/1 are reserved (pad/bos). Deterministic across runs & platforms.
    """
    out = np.empty(len(text.split()), dtype=np.int32)
    for i, w in enumerate(text.split()):
        h = np.uint64(1469598103934665603)
        for ch in w.encode():
            h = np.uint64((int(h) ^ ch) * 1099511628211 % (1 << 64))
        out[i] = 2 + int(h) % (vocab_size - 2)
    return out


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 32000
    n_docs: int = 512
    seed: int = 0
    bos_id: int = 1


class TokenBatchLoader:
    """Packs tokenized documents into dense (batch, seq+1) blocks.

    Returns ``tokens[:, :-1]`` as inputs and ``tokens[:, 1:]`` as labels
    downstream; documents are concatenated with BOS separators and chunked
    (standard LM packing — no padding waste).
    """

    def __init__(self, cfg: LoaderConfig,
                 documents: Optional[Iterator[str]] = None) -> None:
        self.cfg = cfg
        docs = documents if documents is not None else synthetic_documents(
            cfg.n_docs, seed=cfg.seed)
        ids: List[np.ndarray] = []
        for d in docs:
            ids.append(np.asarray([cfg.bos_id], dtype=np.int32))
            ids.append(hash_tokenize(d, cfg.vocab_size))
        self._flat = np.concatenate(ids) if ids else np.zeros(0, np.int32)
        self._pos = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        need = self.cfg.batch_size * (self.cfg.seq_len + 1)
        if len(self._flat) < need:
            raise StopIteration
        if self._pos + need > len(self._flat):
            self._pos = 0  # epoch wrap
        chunk = self._flat[self._pos:self._pos + need]
        self._pos += need
        block = chunk.reshape(self.cfg.batch_size, self.cfg.seq_len + 1)
        return {"tokens": block[:, :-1].copy(), "labels": block[:, 1:].copy()}


class Prefetcher:
    """Double-buffered background prefetch (host pipeline ∥ device step)."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 2) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._fill, args=(it,), daemon=True)
        self._err: Optional[BaseException] = None
        self._thread.start()

    def _fill(self, it: Iterator) -> None:
        try:
            for item in it:
                self._q.put(item)
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
