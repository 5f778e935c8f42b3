"""Content-addressed LRU result cache with TTL, byte budget and a negative
cache (the port's copy of spotter_tpu.caching.result_cache).

Stores post-processed detections (a handful of label/score/box dicts of
Python values, never tensors) keyed on `(model_name, sha256(image bytes),
threshold bucket)`, so a hit costs a dict lookup, not a forward on the
card. Deterministic failures (a non-retryable 4xx `FetchError`, a
`PoisonImageError`) go to a short-TTL negative cache, so a repeat poison
skips the fetch and the bisect instead of re-poisoning a batch.

Never cached (the fill sites, the detector's fetch flight and the
batcher's keyed completion, pass only the classes above in): 5xx, 429,
timeouts and connect errors (retryable); admission sheds and deadlines
(load state, not a property of the image); transient and fatal engine
errors (the next attempt, or the restarted replica, must retry them).

Knobs: `SPOTTER_TPU_CACHE_MAX_MB` (byte budget; 0, the default, disables
the whole tier), `SPOTTER_TPU_CACHE_TTL_S`, `SPOTTER_TPU_CACHE_NEGATIVE_TTL_S`,
`SPOTTER_TPU_CACHE_ANNOTATED` (the finished-JPEG sidecar, default on).

Thread-safe: lookups and fills run on the event loop, /metrics snapshots
and tests may touch it from other threads. Faults injected at
`faults.on_cache` (`cache_error=N`) are contained here: a broken cache
degrades to a miss or a skipped fill, never to a failed request.
"""

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Optional

from spotter_tpu_torch.serving.resilience import _env_float
from spotter_tpu_torch.testing import faults

logger = logging.getLogger(__name__)

CACHE_MAX_MB_ENV = "SPOTTER_TPU_CACHE_MAX_MB"
CACHE_TTL_ENV = "SPOTTER_TPU_CACHE_TTL_S"
CACHE_NEGATIVE_TTL_ENV = "SPOTTER_TPU_CACHE_NEGATIVE_TTL_S"
CACHE_ANNOTATED_ENV = "SPOTTER_TPU_CACHE_ANNOTATED"

DEFAULT_CACHE_MAX_MB = 0.0  # disabled: caching is an explicit deployment opt-in
DEFAULT_CACHE_TTL_S = 600.0
DEFAULT_CACHE_NEGATIVE_TTL_S = 30.0
# negative entries are bounded by count (they hold an exception, not
# detections, so the byte budget is the wrong ruler)
MAX_NEGATIVE_ENTRIES = 4096


class ResultCache:
    """LRU + TTL + byte budget over small detection lists, with a sidecar
    negative cache for deterministic failures."""

    def __init__(
        self,
        max_bytes: int,
        ttl_s: float = DEFAULT_CACHE_TTL_S,
        negative_ttl_s: float = DEFAULT_CACHE_NEGATIVE_TTL_S,
        metrics=None,
        clock=time.monotonic,
        annotated: Optional[bool] = None,
    ) -> None:
        self.max_bytes = int(max_bytes)
        self.ttl_s = ttl_s
        self.negative_ttl_s = negative_ttl_s
        self.metrics = metrics
        self._clock = clock
        # the annotated-JPEG sidecar: a hit can skip decode, draw and
        # re-encode when its entry carries the finished JPEG
        if annotated is None:
            annotated = os.environ.get(CACHE_ANNOTATED_ENV, "1").strip() not in ("", "0")
        self.annotated = bool(annotated)
        self._lock = threading.Lock()
        # key -> [detections, nbytes, expires_at, annotated]; `annotated` is
        # None or {"jpeg": bytes, "detections": [{"label", "box"}]}: one
        # entry, one eviction unit, one byte budget
        self._entries: OrderedDict[str, list] = OrderedDict()
        # key -> (exception, expires_at)
        self._negative: OrderedDict[str, tuple[BaseException, float]] = OrderedDict()
        self._bytes = 0

    @classmethod
    def from_env(cls, metrics=None) -> Optional["ResultCache"]:
        """An armed cache, or None when the tier is off
        (`SPOTTER_TPU_CACHE_MAX_MB` unset or <= 0, the `--cache-mb` flag
        sets it): None means every caller takes the cache-less path."""
        max_mb = _env_float(CACHE_MAX_MB_ENV, DEFAULT_CACHE_MAX_MB)
        if max_mb <= 0:
            return None
        return cls(
            max_bytes=int(max_mb * 1024 * 1024),
            ttl_s=_env_float(CACHE_TTL_ENV, DEFAULT_CACHE_TTL_S),
            negative_ttl_s=_env_float(CACHE_NEGATIVE_TTL_ENV, DEFAULT_CACHE_NEGATIVE_TTL_S),
            metrics=metrics,
        )

    # -- positive entries ---------------------------------------------------

    def get(self, key: str) -> Optional[list]:
        """Detections for `key`, or None. Counts a hit or a miss; returns a
        copy, so no two requests share mutable state."""
        return self.get_entry_full(key)[0]

    def get_entry_full(
        self, key: str, stale_ok: bool = False
    ) -> tuple[Optional[list], bool, Optional[dict]]:
        """(detections, is_stale, annotated) for `key`, or (None, False,
        None). With `stale_ok` (the brownout's stale rung) an expired entry
        is returned with `is_stale=True` and kept; otherwise it is dropped
        and misses. `annotated` is the sidecar {"jpeg": bytes, "detections":
        [...]} when one was attached, else None."""
        try:
            faults.on_cache("get", key)
            with self._lock:
                entry = self._entries.get(key)
                stale = entry is not None and entry[2] <= self._clock()
                if stale and not stale_ok:
                    self._drop(key)
                    entry = None
                    stale = False
                if entry is None:
                    self._record("record_cache_miss")
                    return None, False, None
                self._entries.move_to_end(key)
                self._record("record_cache_hit")
                if stale:
                    self._record("record_stale_served")
                annotated = entry[3]
                if annotated is not None:
                    annotated = {
                        "jpeg": annotated["jpeg"],
                        "detections": [dict(d) for d in annotated["detections"]],
                    }
                return [dict(d) for d in entry[0]], stale, annotated
        except Exception:
            logger.exception("result cache get(%s) failed; treating as miss", key)
            self._record("record_cache_miss")
            return None, False, None

    def put(self, key: str, detections: list) -> None:
        """Fill (idempotent; last writer wins). A value bigger than the
        whole budget is not stored."""
        try:
            faults.on_cache("put", key)
            nbytes = self._estimate_nbytes(key, detections)
            if nbytes > self.max_bytes:
                return
            value = [dict(d) for d in detections]
            with self._lock:
                if key in self._entries:
                    self._drop(key)
                self._entries[key] = [value, nbytes, self._clock() + self.ttl_s, None]
                self._bytes += nbytes
                self._evict_over_budget()
                self._publish_size()
        except Exception:
            logger.exception("result cache put(%s) failed; skipping fill", key)

    def attach_annotated(self, key: str, jpeg: bytes, detections: list[dict]) -> None:
        """Attach the finished draw output (annotated JPEG and the
        amenity-filtered label/box list) to a fresh entry, so the next hit
        skips decode, draw and re-encode. Its bytes count against the same
        budget; a JPEG that would blow it is not attached."""
        if not self.annotated:
            return
        try:
            faults.on_cache("put", key)
            extra = len(jpeg) + self._estimate_nbytes("", detections)
            with self._lock:
                entry = self._entries.get(key)
                if entry is None or entry[3] is not None or entry[2] <= self._clock():
                    return
                if entry[1] + extra > self.max_bytes:
                    return
                entry[3] = {"jpeg": jpeg, "detections": [dict(d) for d in detections]}
                entry[1] += extra
                self._bytes += extra
                # freshly useful: the attach itself must not evict the key
                self._entries.move_to_end(key)
                self._evict_over_budget()
                self._publish_size()
        except Exception:
            logger.exception("result cache attach_annotated(%s) failed; skipping", key)

    def _evict_over_budget(self) -> None:
        # caller holds the lock
        evicted = 0
        while self._bytes > self.max_bytes and self._entries:
            self._drop(next(iter(self._entries)))
            evicted += 1
        if evicted and self.metrics is not None:
            self.metrics.record_cache_eviction(evicted)

    # -- negative entries ---------------------------------------------------

    def get_negative(self, key: str) -> Optional[BaseException]:
        """The cached deterministic failure for `key`, or None. The caller
        re-raises it; expiry means the next attempt really retries."""
        try:
            faults.on_cache("get_negative", key)
            with self._lock:
                entry = self._negative.get(key)
                if entry is None:
                    return None
                if entry[1] <= self._clock():
                    del self._negative[key]
                    return None
                self._negative.move_to_end(key)
                self._record("record_cache_negative_hit")
                return entry[0]
        except Exception:
            logger.exception("result cache get_negative(%s) failed; treating as miss", key)
            return None

    def put_negative(self, key: str, exc: BaseException) -> None:
        try:
            faults.on_cache("put_negative", key)
            with self._lock:
                self._negative[key] = (exc, self._clock() + self.negative_ttl_s)
                self._negative.move_to_end(key)
                while len(self._negative) > MAX_NEGATIVE_ENTRIES:
                    self._negative.popitem(last=False)
        except Exception:
            logger.exception("result cache put_negative(%s) failed; skipping", key)

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """/healthz-shaped snapshot of the cache's size state."""
        with self._lock:
            return {
                "enabled": True,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "negative_entries": len(self._negative),
                "annotated_entries": sum(1 for e in self._entries.values() if e[3] is not None),
                "ttl_s": self.ttl_s,
                "negative_ttl_s": self.negative_ttl_s,
            }

    # -- internals ----------------------------------------------------------

    def _drop(self, key: str) -> None:
        # caller holds the lock
        value = self._entries.pop(key, None)
        if value is not None:
            self._bytes -= value[1]

    def _publish_size(self) -> None:
        # caller holds the lock
        if self.metrics is not None:
            self.metrics.set_cache_size(len(self._entries), self._bytes)

    def _record(self, method: str) -> None:
        if self.metrics is not None:
            getattr(self.metrics, method)()

    @staticmethod
    def _estimate_nbytes(key: str, detections: list) -> int:
        # detections are small JSON-shaped dicts: their JSON encoding is a
        # deterministic size proxy for the budget
        try:
            payload = len(json.dumps(detections))
        except (TypeError, ValueError):
            payload = len(repr(detections))
        return len(key) + payload + 96  # + OrderedDict/list overhead
