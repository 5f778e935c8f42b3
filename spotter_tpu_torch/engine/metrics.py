"""Serving metrics: images/sec, latency percentiles and the resilience
counters (lean port of spotter_tpu.engine.metrics).

Keeps the counters and the snapshot that the batcher, the detector and the
engine touch, the open-vocabulary text cache's hits, misses and resolve
times, and the device-efficiency ledger (`metrics.perf`, the port's
`obs.perf`: MFU, duty cycle, the capture ledger, memory gauges, SLO burn),
the H2D bytes, the decode pool's queue gauge and the weights digest of the
identity block, and the batch-latency histogram whose buckets carry
trace-id exemplars (obs/prom.py renders it), the result cache's
hit/miss/negative/eviction and coalescing counters with its size, the
stale serves of the brownout rung, and the /detect wire's bytes and
encodings, under the JAX package's names. Its mergeable stage histograms
are not ported. Lock-light
counters plus a bounded reservoir; `snapshot()` is what /metrics serves.
"""

import os
import socket
import threading
import time
from collections import deque

from spotter_tpu_torch.obs.perf import PerfLedger

# Batch-latency histogram bounds (ms): /metrics?format=prometheus renders
# spotter_tpu_latency_ms_bucket{le="..."} with trace-id exemplars, so a
# tail bucket links to the flight-recorder trace that landed in it.
LATENCY_BUCKETS_MS = (
    5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
    float("inf"),
)

REPLICA_ID_ENV = "SPOTTER_TPU_REPLICA_ID"
BUILD_VERSION_ENV = "SPOTTER_TPU_BUILD_VERSION"
DEFAULT_BUILD_VERSION = "dev"
# an operator-pinned weights digest outranks the engine's computed one
WEIGHTS_DIGEST_ENV = "SPOTTER_TPU_WEIGHTS_DIGEST"


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


def default_weights_digest() -> str | None:
    """The operator-pinned weights digest, or None to let the engine's own
    `weights_digest()` stand."""
    return os.environ.get(WEIGHTS_DIGEST_ENV, "").strip() or None


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
        self._latency_bucket_counts = [0] * len(LATENCY_BUCKETS_MS)
        self._latency_sum_ms = 0.0
        self._latency_count = 0
        # bucket label -> the last traced batch that landed in it
        self._latency_exemplars: dict[str, dict] = {}
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
        self._weights_digest = default_weights_digest()
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
        # the scheduler's packs: each dispatch's padded-pixel waste (measured
        # under FIFO too, against the static bucket, so the per-bucket
        # baseline shows), the deadline slack each deadline-carrying item had
        # left at dispatch, and the dispatches staged into a ragged canvas
        self._padding_waste_pct: deque[float] = deque(maxlen=window)
        self._slack_at_dispatch_ms: deque[float] = deque(maxlen=window)
        self._ragged_packs_total = 0
        # open-vocabulary query-set resolves (caching/text_cache.py)
        self._text_cache_hits_total = 0
        self._text_cache_misses_total = 0
        self._text_hit_ms: deque[float] = deque(maxlen=window)
        self._text_miss_ms: deque[float] = deque(maxlen=window)
        # the result cache: hits, misses, negative hits (a cached
        # deterministic failure short-circuited the fetch or the bisect),
        # evictions, waiters coalesced onto an in-flight fetch (URL) or
        # engine submit (content hash), its size, and stale-rung serves
        self._cache_hits_total = 0
        self._cache_misses_total = 0
        self._cache_negative_hits_total = 0
        self._cache_evictions_total = 0
        self._coalesced_fetches_total = 0
        self._coalesced_submits_total = 0
        self._cache_entries = 0
        self._cache_bytes = 0
        self._stale_served_total = 0
        # /detect bytes on the wire each way, and the responses sent as
        # binary frames vs JSON
        self._wire_bytes_in_total = 0
        self._wire_bytes_out_total = 0
        self._wire_requests_total = 0
        self._wire_frame_responses_total = 0
        self._wire_json_responses_total = 0
        # host -> device bytes the engine staged, and the decode pool's
        # submitted-but-unfinished photos when it last staged
        self._h2d_bytes_total = 0
        self._h2d_images_total = 0
        self._decode_queue_depth = 0
        # the device-efficiency ledger: the engine feeds dispatches and
        # captures directly (`metrics.perf.record_dispatch(...)`); the SLO
        # burn windows are fed below (completed images good, sheds and
        # deadline misses bad). SPOTTER_TPU_PERF_LEDGER=0 makes every perf
        # record a no-op while the snapshot keys stay present.
        self.perf = PerfLedger()

    def record_batch(
        self, batch_size: int, latency_s: float, stages: dict[str, float] | None = None,
        trace_id: str | None = None,
    ) -> None:
        """One engine batch: its size, its latency, and optional per-stage
        seconds (decode / h2d / device / postprocess). `trace_id` (when the
        batch carried a traced request) becomes the exemplar of the latency
        bucket this batch landed in."""
        latency_ms = latency_s * 1000.0
        with self._lock:
            self._images_total += batch_size
            self._batches_total += 1
            self._batch_sizes.append(batch_size)
            self._latencies_ms.append(latency_ms)
            self._latency_sum_ms += latency_ms
            self._latency_count += 1
            for i, le in enumerate(LATENCY_BUCKETS_MS):
                if latency_ms <= le:
                    self._latency_bucket_counts[i] += 1
                    if trace_id is not None:
                        key = "+Inf" if le == float("inf") else f"{le:g}"
                        self._latency_exemplars[key] = {
                            "trace_id": trace_id, "value": latency_ms, "ts": time.time()}
                    break
            self._arrivals.append((time.monotonic(), batch_size))
            if self.perf.enabled:
                self.perf.slo.good(batch_size)
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
        if self.perf.enabled:  # sheds spend SLO error budget
            self.perf.slo.bad(n)

    def record_deadline_exceeded(self, n: int = 1) -> None:
        with self._lock:
            self._deadline_exceeded_total += n
        if self.perf.enabled:  # deadline misses spend SLO error budget
            self.perf.slo.bad(n)

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

    def record_h2d_bytes(self, nbytes: int, n_images: int) -> None:
        """One staged chunk: the bytes uploaded and the real images in it."""
        with self._lock:
            self._h2d_bytes_total += nbytes
            self._h2d_images_total += n_images

    def set_decode_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._decode_queue_depth = depth

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

    def record_pack(
        self,
        padding_waste_pct: float | None = None,
        slack_ms: list[float] | None = None,
        ragged: bool = False,
    ) -> None:
        """One scheduler dispatch: its padded-pixel waste, the deadline slack
        each deadline-carrying item had left (the slack-ordering control
        signal), and whether it staged into a ragged canvas."""
        with self._lock:
            if padding_waste_pct is not None:
                self._padding_waste_pct.append(padding_waste_pct)
            if slack_ms:
                self._slack_at_dispatch_ms.extend(slack_ms)
            if ragged:
                self._ragged_packs_total += 1

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

    def record_cache_hit(self, n: int = 1) -> None:
        """A lookup answered from the content-addressed result cache."""
        with self._lock:
            self._cache_hits_total += n

    def record_cache_miss(self, n: int = 1) -> None:
        with self._lock:
            self._cache_misses_total += n

    def record_cache_negative_hit(self, n: int = 1) -> None:
        """A cached deterministic failure (4xx fetch, poison) short-circuited
        the fetch or the bisect."""
        with self._lock:
            self._cache_negative_hits_total += n

    def record_cache_eviction(self, n: int = 1) -> None:
        with self._lock:
            self._cache_evictions_total += n

    def record_coalesced_fetch(self, n: int = 1) -> None:
        """A request attached to an in-flight fetch of the same URL."""
        with self._lock:
            self._coalesced_fetches_total += n

    def record_coalesced_submit(self, n: int = 1) -> None:
        """A request attached to an in-flight engine call for the same
        content hash instead of enqueuing its own image."""
        with self._lock:
            self._coalesced_submits_total += n

    def record_stale_served(self, n: int = 1) -> None:
        """An answer served from an expired cache entry (the brownout's stale
        rung): the `degraded: stale` marker's counter."""
        with self._lock:
            self._stale_served_total += n

    def set_cache_size(self, entries: int, nbytes: int) -> None:
        with self._lock:
            self._cache_entries = entries
            self._cache_bytes = nbytes

    def record_wire(self, bytes_in: int, bytes_out: int, frame: bool) -> None:
        """One /detect exchange's bytes on the wire: the request body in, the
        response body out, and the encoding the response used."""
        with self._lock:
            self._wire_bytes_in_total += int(bytes_in)
            self._wire_bytes_out_total += int(bytes_out)
            self._wire_requests_total += 1
            if frame:
                self._wire_frame_responses_total += 1
            else:
                self._wire_json_responses_total += 1

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

    def set_identity(
        self,
        model: str | None = None,
        version: str | None = None,
        weights_digest: str | None = None,
    ) -> None:
        """Stamp the snapshot identity block; only non-None fields change."""
        with self._lock:
            if model is not None:
                self._model = model
            if version is not None:
                self._version = version
            if weights_digest is not None:
                self._weights_digest = weights_digest

    @property
    def version(self) -> str:
        with self._lock:
            return self._version

    @property
    def replica_id(self) -> str:
        with self._lock:
            return self._replica_id

    def snapshot(self) -> dict:
        # outside the metrics lock: the perf ledger locks itself
        perf_snap = self.perf.snapshot()
        with self._lock:
            now = time.monotonic()
            recent = [(t, n) for t, n in self._arrivals if now - t <= 30.0]
            if recent:
                span = max(now - recent[0][0], 1e-9)
                images_per_sec = sum(n for _, n in recent) / span
            else:
                images_per_sec = 0.0
            latency = _quantiles(self._latencies_ms) if self._latencies_ms else {}
            cumulative, buckets = 0, []
            for le, count in zip(LATENCY_BUCKETS_MS, self._latency_bucket_counts):
                cumulative += count
                buckets.append([None if le == float("inf") else le, cumulative])
            stages = {
                f"stage_{name}_ms_{tag}": v
                for name, ring in self._stages.items() if ring
                for tag, v in _quantiles(ring).items()
            }
            return {
                **perf_snap,
                **stages,
                "replica": {
                    "replica_id": self._replica_id,
                    "pid": os.getpid(),
                    "generation": self._generation,
                    "uptime_s": round(now - self._started, 3),
                    "model": self._model,
                    "version": self._version,
                    "weights_digest": self._weights_digest,
                },
                "h2d_bytes_total": self._h2d_bytes_total,
                "h2d_bytes_per_image": (
                    self._h2d_bytes_total / self._h2d_images_total
                    if self._h2d_images_total else 0.0
                ),
                "decode_pool_queue_depth": self._decode_queue_depth,
                "padding_waste_pct": (
                    sum(self._padding_waste_pct) / len(self._padding_waste_pct)
                    if self._padding_waste_pct else None
                ),
                "slack_at_dispatch_ms": (
                    _quantiles(self._slack_at_dispatch_ms)
                    if self._slack_at_dispatch_ms else None
                ),
                "ragged_packs_total": self._ragged_packs_total,
                "aggregate_bucket": self._aggregate_bucket,
                "latency_ms_histogram": {
                    "buckets": buckets,
                    "sum": self._latency_sum_ms,
                    "count": self._latency_count,
                    "exemplars": dict(self._latency_exemplars),
                },
                "images_total": self._images_total,
                "errors_total": self._errors_total,
                "poison_isolated_total": self._poison_isolated_total,
                "batch_retries_total": self._batch_retries_total,
                "fatal_engine_errors_total": self._fatal_engine_errors_total,
                "cache_hits_total": self._cache_hits_total,
                "cache_misses_total": self._cache_misses_total,
                "cache_negative_hits_total": self._cache_negative_hits_total,
                "cache_evictions_total": self._cache_evictions_total,
                "coalesced_fetches_total": self._coalesced_fetches_total,
                "coalesced_submits_total": self._coalesced_submits_total,
                "cache_entries": self._cache_entries,
                "cache_bytes": self._cache_bytes,
                "wire_bytes_in_total": self._wire_bytes_in_total,
                "wire_bytes_out_total": self._wire_bytes_out_total,
                "wire_requests_total": self._wire_requests_total,
                "wire_frame_responses_total": self._wire_frame_responses_total,
                "wire_json_responses_total": self._wire_json_responses_total,
                "wire_bytes_out_per_request": (
                    self._wire_bytes_out_total / self._wire_requests_total
                    if self._wire_requests_total else 0.0
                ),
                "admit_limit": self._admit_limit,
                "admit_in_flight": self._admit_in_flight,
                "admit_sheds_total": dict(self._admit_sheds_total),
                "brownout_rung": self._brownout_rung,
                "brownout_transitions_total": self._brownout_transitions_total,
                "stale_served_total": self._stale_served_total,
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
