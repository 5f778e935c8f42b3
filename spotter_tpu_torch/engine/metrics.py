"""Serving metrics: images/sec, latency percentiles and the resilience
counters (lean port of spotter_tpu.engine.metrics).

Keeps the counters and the snapshot that the batcher, the detector and the
engine touch, and the open-vocabulary text cache's hits, misses and resolve
times. The JAX package's device-efficiency ledger (`obs.perf`), result
caching and wire counters, latency exemplars and mergeable histograms are
not ported yet. Lock-light counters plus a bounded
reservoir; `snapshot()` is what /metrics serves.
"""

import os
import socket
import threading
import time
from collections import deque

REPLICA_ID_ENV = "SPOTTER_TPU_REPLICA_ID"
BUILD_VERSION_ENV = "SPOTTER_TPU_BUILD_VERSION"
DEFAULT_BUILD_VERSION = "dev"


def default_replica_id() -> str:
    """The env override wins, else host:pid."""
    rid = os.environ.get(REPLICA_ID_ENV, "").strip()
    if rid:
        return rid
    try:
        host = socket.gethostname() or "localhost"
    except OSError:
        host = "localhost"
    return f"{host}:{os.getpid()}"


def default_build_version() -> str:
    """The deploy version this process serves (env, else "dev")."""
    return os.environ.get(BUILD_VERSION_ENV, "").strip() or DEFAULT_BUILD_VERSION


def _quantiles(values) -> dict[str, float]:
    vals = sorted(values)
    return {
        tag: vals[min(int(p * len(vals)), len(vals) - 1)]
        for p, tag in ((0.50, "p50"), (0.90, "p90"), (0.99, "p99"))
    }


def _median(values) -> float | None:
    """Median of a sample deque, None when empty (as the JAX package's)."""
    if not values:
        return None
    vals = sorted(values)
    return vals[len(vals) // 2]


class Metrics:
    def __init__(self, window: int = 2048) -> None:
        self._lock = threading.Lock()
        self._window = window
        self._latencies_ms: deque[float] = deque(maxlen=window)
        self._batch_sizes: deque[int] = deque(maxlen=window)
        # (timestamp, batch_size) ring for the rate over the last 30 s
        self._arrivals: deque[tuple[float, int]] = deque(maxlen=window)
        self._stages: dict[str, deque[float]] = {}
        self._started = time.monotonic()
        self._images_total = 0
        self._errors_total = 0
        self._batches_total = 0
        self._replica_id = default_replica_id()
        self._model: str | None = None
        self._version = default_build_version()
        self._generation = 0
        # resilience: sheds, deadlines, watchdog, breaker, drain
        self._shed_total = 0
        self._deadline_exceeded_total = 0
        self._batch_timeouts_total = 0
        self._breaker_state = "closed"
        self._breaker_transitions_total = 0
        self._draining = False
        # lifecycle
        self._time_to_ready_s: float | None = None
        self._restarts_total = 0
        self._aggregate_bucket = 0
        # engine fault domain
        self._poison_isolated_total = 0
        self._batch_retries_total = 0
        self._fatal_engine_errors_total = 0
        # overload control (None limit while the tier is off)
        self._admit_limit: float | None = None
        self._admit_in_flight = 0
        self._admit_sheds_total = {"slo": 0, "bulk": 0}
        self._brownout_rung = 0
        self._brownout_transitions_total = 0
        # deadline slack each deadline-carrying item had left at dispatch
        self._slack_at_dispatch_ms: deque[float] = deque(maxlen=window)
        # open-vocabulary query-set resolves (caching/text_cache.py)
        self._text_cache_hits_total = 0
        self._text_cache_misses_total = 0
        self._text_hit_ms: deque[float] = deque(maxlen=window)
        self._text_miss_ms: deque[float] = deque(maxlen=window)

    def record_batch(
        self, batch_size: int, latency_s: float, stages: dict[str, float] | None = None
    ) -> None:
        """One engine batch: its size, its latency, and optional per-stage
        seconds (decode / h2d / device / postprocess)."""
        with self._lock:
            self._images_total += batch_size
            self._batches_total += 1
            self._batch_sizes.append(batch_size)
            self._latencies_ms.append(latency_s * 1000.0)
            self._arrivals.append((time.monotonic(), batch_size))
            for name, secs in (stages or {}).items():
                self._stage(name).append(secs * 1000.0)

    def _stage(self, name: str) -> deque:
        # caller holds the lock
        ring = self._stages.get(name)
        if ring is None:
            ring = self._stages[name] = deque(maxlen=self._window)
        return ring

    def record_stage_samples(self, name: str, values_ms: list[float]) -> None:
        """Per-item samples of a named stage outside `record_batch` (the
        batcher's queue_wait, the AIMD limiter's control signal)."""
        with self._lock:
            self._stage(name).extend(values_ms)

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self._errors_total += n

    def record_shed(self, n: int = 1) -> None:
        """A request rejected at admission (queue full / breaker open / drain)."""
        with self._lock:
            self._shed_total += n

    def record_deadline_exceeded(self, n: int = 1) -> None:
        with self._lock:
            self._deadline_exceeded_total += n

    def record_batch_timeout(self, n_images: int) -> None:
        """Watchdog fired on a hung engine call; images count as errors too."""
        with self._lock:
            self._batch_timeouts_total += 1
            self._errors_total += n_images

    def record_breaker_transition(self, state: str) -> None:
        with self._lock:
            self._breaker_state = state
            self._breaker_transitions_total += 1

    def set_draining(self, draining: bool) -> None:
        with self._lock:
            self._draining = draining

    def record_poison_isolated(self, n: int = 1) -> None:
        with self._lock:
            self._poison_isolated_total += n

    def record_batch_retry(self, n: int = 1) -> None:
        """A failed batch was split and retried (poison bisect or OOM split)."""
        with self._lock:
            self._batch_retries_total += n

    def record_fatal_engine_error(self) -> None:
        with self._lock:
            self._fatal_engine_errors_total += 1

    def set_admit_state(self, limit: int, in_flight: int) -> None:
        with self._lock:
            self._admit_limit = limit
            self._admit_in_flight = in_flight

    def record_admit_shed(self, cls: str, n: int = 1) -> None:
        with self._lock:
            if cls not in self._admit_sheds_total:
                cls = "slo"
            self._admit_sheds_total[cls] += n

    def admit_sheds_count(self) -> int:
        """All-classes shed count: the brownout ladder's hold signal."""
        with self._lock:
            return sum(self._admit_sheds_total.values())

    def set_brownout_rung(self, rung: int) -> None:
        with self._lock:
            self._brownout_rung = rung

    def record_brownout_transition(self, n: int = 1) -> None:
        with self._lock:
            self._brownout_transitions_total += n

    def record_slack(self, slack_ms: list[float]) -> None:
        """One dispatch: the deadline slack each deadline-carrying item had
        left (the slack-ordering control signal)."""
        with self._lock:
            self._slack_at_dispatch_ms.extend(slack_ms)

    def record_text_cache(self, hit: bool, resolve_ms: float | None) -> None:
        """One open-vocabulary query-set resolve: the cache outcome and its
        wall time (a miss's includes the text-tower encode; a hit's is the
        lookup)."""
        with self._lock:
            if hit:
                self._text_cache_hits_total += 1
                if resolve_ms is not None:
                    self._text_hit_ms.append(resolve_ms)
            else:
                self._text_cache_misses_total += 1
                if resolve_ms is not None:
                    self._text_miss_ms.append(resolve_ms)

    def set_aggregate_bucket(self, bucket: int) -> None:
        with self._lock:
            self._aggregate_bucket = bucket

    def set_time_to_ready(self, seconds: float) -> None:
        with self._lock:
            self._time_to_ready_s = seconds

    def set_restarts(self, n: int) -> None:
        with self._lock:
            self._restarts_total = n
            self._generation = int(n)

    def set_identity(self, model: str | None = None, version: str | None = None) -> None:
        with self._lock:
            if model is not None:
                self._model = model
            if version is not None:
                self._version = version

    @property
    def version(self) -> str:
        with self._lock:
            return self._version

    @property
    def replica_id(self) -> str:
        with self._lock:
            return self._replica_id

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            recent = [(t, n) for t, n in self._arrivals if now - t <= 30.0]
            if recent:
                span = max(now - recent[0][0], 1e-9)
                images_per_sec = sum(n for _, n in recent) / span
            else:
                images_per_sec = 0.0
            latency = _quantiles(self._latencies_ms) if self._latencies_ms else {}
            stages = {
                f"stage_{name}_ms_{tag}": v
                for name, ring in self._stages.items() if ring
                for tag, v in _quantiles(ring).items()
            }
            return {
                **stages,
                "replica": {
                    "replica_id": self._replica_id,
                    "pid": os.getpid(),
                    "generation": self._generation,
                    "uptime_s": round(now - self._started, 3),
                    "model": self._model,
                    "version": self._version,
                },
                "slack_at_dispatch_ms": (
                    _quantiles(self._slack_at_dispatch_ms)
                    if self._slack_at_dispatch_ms else None
                ),
                "aggregate_bucket": self._aggregate_bucket,
                "images_total": self._images_total,
                "errors_total": self._errors_total,
                "poison_isolated_total": self._poison_isolated_total,
                "batch_retries_total": self._batch_retries_total,
                "fatal_engine_errors_total": self._fatal_engine_errors_total,
                "admit_limit": self._admit_limit,
                "admit_in_flight": self._admit_in_flight,
                "admit_sheds_total": dict(self._admit_sheds_total),
                "brownout_rung": self._brownout_rung,
                "brownout_transitions_total": self._brownout_transitions_total,
                "shed_total": self._shed_total,
                "deadline_exceeded_total": self._deadline_exceeded_total,
                "batch_timeouts_total": self._batch_timeouts_total,
                "breaker_state": self._breaker_state,
                "breaker_transitions_total": self._breaker_transitions_total,
                "draining": self._draining,
                "time_to_ready_s": self._time_to_ready_s,
                "text_cache_hits_total": self._text_cache_hits_total,
                "text_cache_misses_total": self._text_cache_misses_total,
                "text_cache_hit_ms_p50": _median(self._text_hit_ms),
                "text_cache_miss_ms_p50": _median(self._text_miss_ms),
                "restarts_total": self._restarts_total,
                "batches_total": self._batches_total,
                "mean_batch_size": (
                    sum(self._batch_sizes) / len(self._batch_sizes)
                    if self._batch_sizes else 0.0
                ),
                "images_per_sec": images_per_sec,
                "latency_ms_p50": latency.get("p50", 0.0),
                "latency_ms_p90": latency.get("p90", 0.0),
                "latency_ms_p99": latency.get("p99", 0.0),
                "uptime_s": now - self._started,
            }
