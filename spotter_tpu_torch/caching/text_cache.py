"""Text-embedding cache for open-vocabulary detection (copy of
spotter_tpu.caching.text_cache).

OWL-ViT's text tower is the half of an open-vocabulary request that the
closed-set path never pays. Vocabularies repeat (a client reuses its label
set on every image), so the resolver memoizes encoded query sets keyed
`model|sha256(sorted queries)` (caching/keys.py): a repeated vocabulary
costs one dict lookup.

The cached value is a `QuerySet`: labels in canonical (sorted) order, the
normalized (Q_pad, proj) embedding matrix padded to a multiple of
`SPOTTER_TPU_QUERY_PAD` (default 8) with a validity mask. `QuerySet.key`
doubles as the scheduler's batch group: a dispatch runs one query set, so
the batcher never mixes two vocabularies in one batch. Padded slots get
NEG_INF logits in the class head, so they never win a patch's argmax.

Thread-safe (resolve runs in an executor off the event loop); the entry
count is bounded (`SPOTTER_TPU_TEXT_CACHE_ENTRIES`, least recently used
dropped first).
"""

import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from spotter_tpu_torch.caching.keys import queries_digest, queries_key

logger = logging.getLogger(__name__)

QUERY_PAD_ENV = "SPOTTER_TPU_QUERY_PAD"
DEFAULT_QUERY_PAD = 8
TEXT_CACHE_ENTRIES_ENV = "SPOTTER_TPU_TEXT_CACHE_ENTRIES"
DEFAULT_TEXT_CACHE_ENTRIES = 256


@dataclass(frozen=True)
class QuerySet:
    """One resolved open-vocabulary query set, engine-ready.

    `embeds` is (Q_pad, proj) float32 with rows past `len(labels)` zeroed;
    `mask` is (Q_pad,) int32, 1 = a real query.
    """

    key: str  # queries_key(model, queries): also the scheduler's group id
    digest: str  # sha256 over the sorted queries
    labels: tuple  # canonical sorted query strings, index == label id
    embeds: np.ndarray
    mask: np.ndarray

    @property
    def id2label(self) -> dict[int, str]:
        return dict(enumerate(self.labels))


def query_pad() -> int:
    raw = os.environ.get(QUERY_PAD_ENV, "").strip()
    try:
        pad = int(raw) if raw else DEFAULT_QUERY_PAD
    except ValueError:
        raise ValueError(f"{QUERY_PAD_ENV} must be an integer, got {raw!r}") from None
    return max(1, pad)


class TextQueryResolver:
    """queries -> QuerySet through the memoized text encoder.

    `encoder` is `BuiltDetector.text_encoder` (list[str] -> (Q, proj)
    float32). `metrics` (the engine's Metrics) gets hit/miss counts and
    resolve times, which /metrics shows.
    """

    def __init__(
        self,
        model_name: str,
        encoder: Callable,
        metrics=None,
        max_entries: Optional[int] = None,
        pad: Optional[int] = None,
    ) -> None:
        self.model_name = model_name
        self.encoder = encoder
        self.metrics = metrics
        if max_entries is None:
            raw = os.environ.get(TEXT_CACHE_ENTRIES_ENV, "").strip()
            max_entries = int(raw) if raw else DEFAULT_TEXT_CACHE_ENTRIES
        self.max_entries = max(1, max_entries)
        self.pad = pad if pad is not None else query_pad()
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, QuerySet] = OrderedDict()

    def resolve(self, queries) -> QuerySet:
        """The memoized encode. Raises ValueError on an empty query set.

        Holding the lock across the encode serializes concurrent misses for
        different keys too: the encoder runs the model's text tower, and two
        towers racing on one device buy nothing.
        """
        t0 = time.monotonic()
        labels = tuple(sorted(str(q).strip() for q in queries if str(q).strip()))
        if not labels:
            raise ValueError("queries must contain at least one non-empty string")
        key = queries_key(self.model_name, labels)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self._record(True, (time.monotonic() - t0) * 1000.0)
                return entry
            embeds = np.asarray(self.encoder(list(labels)), np.float32)
            q, d = embeds.shape
            q_pad = -(-q // self.pad) * self.pad
            padded = np.zeros((q_pad, d), np.float32)
            padded[:q] = embeds
            mask = np.zeros((q_pad,), np.int32)
            mask[:q] = 1
            entry = QuerySet(
                key=key,
                digest=queries_digest(labels),
                labels=labels,
                embeds=padded,
                mask=mask,
            )
            self._entries[key] = entry
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            self._record(False, (time.monotonic() - t0) * 1000.0)
            return entry

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "query_pad": self.pad,
            }

    def _record(self, hit: bool, resolve_ms: Optional[float]) -> None:
        if self.metrics is not None:
            try:
                self.metrics.record_text_cache(hit, resolve_ms)
            except Exception:  # metrics never fail a resolve
                logger.exception("recording a text-cache resolve failed")
