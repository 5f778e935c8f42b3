"""Flight recorder: a bounded ring of completed request traces + pins (the
port's own copy of spotter_tpu.obs.recorder).

Three retention classes:

- **ring**: the last `SPOTTER_TPU_TRACE_RING` completed traces (default
  256; `0` disables the recorder entirely: `begin_trace` then returns None
  and every span helper is a no-op, so the off path allocates nothing);
- **slowest**: the `SPOTTER_TPU_TRACE_SLOWEST_K` slowest traces seen since
  start (default 16), pinned so a tail-latency event survives ring churn;
- **errors**: every errored/poison/fatal/shed trace (bounded at
  `ERROR_PIN_MAX`), pinned for the same reason.

`/debug/traces` (admin-token-gated, obs/http.py) serves `snapshot()`;
`dump_for_exit()` writes the same snapshot to disk when the process leaves
on one of `DUMP_EXIT_CODES` (83 preemption / 84 crash-loop / 85 fatal
engine), so the trace of the request that killed a replica survives it.
The integrity exit (86) is not among them, as in the JAX package: the
plane calls `dump_for_exit(86)` and nothing is written.
"""

import json
import logging
import os
import tempfile
import threading
import time
from collections import deque

from spotter_tpu_torch.obs.trace import Trace

logger = logging.getLogger(__name__)

TRACE_RING_ENV = "SPOTTER_TPU_TRACE_RING"
TRACE_SLOWEST_K_ENV = "SPOTTER_TPU_TRACE_SLOWEST_K"
TRACE_DUMP_DIR_ENV = "SPOTTER_TPU_TRACE_DUMP_DIR"

DEFAULT_TRACE_RING = 256
DEFAULT_SLOWEST_K = 16
ERROR_PIN_MAX = 64

# The exits worth a post-mortem dump: preemption (83), supervisor
# crash-loop circuit (84), fatal engine error (85).
DUMP_EXIT_CODES = (83, 84, 85)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


class FlightRecorder:
    def __init__(
        self,
        ring: int | None = None,
        slowest_k: int | None = None,
    ) -> None:
        if ring is None:
            ring = _env_int(TRACE_RING_ENV, DEFAULT_TRACE_RING)
        if slowest_k is None:
            slowest_k = _env_int(TRACE_SLOWEST_K_ENV, DEFAULT_SLOWEST_K)
        self.ring_size = max(0, ring)
        self.slowest_k = max(0, slowest_k)
        self._lock = threading.Lock()
        self._ring: deque[Trace] = deque(maxlen=max(1, self.ring_size))
        self._slowest: list[Trace] = []  # kept sorted slowest-first
        self._errors: deque[Trace] = deque(maxlen=ERROR_PIN_MAX)
        self.recorded_total = 0
        self.errors_total = 0

    @property
    def enabled(self) -> bool:
        return self.ring_size > 0

    def record(self, trace: Trace | None) -> None:
        """Called once per completed request (the HTTP layer, after the
        response is built). Stamps the total duration if the caller hasn't."""
        if trace is None or not self.enabled:
            return
        trace.finish()
        with self._lock:
            self.recorded_total += 1
            self._ring.append(trace)
            if trace.status != "ok":
                self.errors_total += 1
                self._errors.append(trace)
            if self.slowest_k > 0:
                # fast path: the pin set is full and this trace is quicker
                # than everything in it, so no sort
                dur = trace.duration_ms or 0.0
                if (
                    len(self._slowest) < self.slowest_k
                    or dur > (self._slowest[-1].duration_ms or 0.0)
                ):
                    self._slowest.append(trace)
                    self._slowest.sort(
                        key=lambda t: t.duration_ms or 0.0, reverse=True
                    )
                    del self._slowest[self.slowest_k:]

    # -- lookup / export --

    def _all(self) -> list[Trace]:
        with self._lock:
            seen: dict[int, Trace] = {}
            for t in list(self._ring) + self._slowest + list(self._errors):
                seen[id(t)] = t
            return list(seen.values())

    def lookup(self, key: str) -> list[dict]:
        """Traces whose trace id or request id matches `key` (retrieve a
        trace by its X-Request-ID)."""
        key = key.strip()
        return [
            t.to_dict()
            for t in self._all()
            if t.trace_id == key or t.request_id == key
        ]

    def slowest_traces(self, k: int | None = None) -> list[dict]:
        """The pinned slowest traces, slowest-first."""
        with self._lock:
            top = [t.to_dict() for t in self._slowest]
        return top[: k if k is not None else self.slowest_k]

    def trace_ids_between(self, t0_wall: float, t1_wall: float) -> list[str]:
        """Trace ids of recorded traces whose [start, end] wall-clock window
        overlaps [t0_wall, t1_wall]: the requests whose device work landed
        inside a profiler capture."""
        out = []
        for t in self._all():
            start = getattr(t, "started_at", None)
            if start is None:
                continue
            end = start + (t.duration_ms or 0.0) / 1e3
            if start <= t1_wall and end >= t0_wall:
                out.append(t.trace_id)
        return sorted(set(out))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "ring_size": self.ring_size,
                "slowest_k": self.slowest_k,
                "recorded_total": self.recorded_total,
                "errors_total": self.errors_total,
                "ring": [t.to_dict() for t in self._ring],
                "slowest": [t.to_dict() for t in self._slowest],
                "errors": [t.to_dict() for t in self._errors],
            }

    def dump(self, path: str) -> str:
        payload = {
            "dumped_at": time.time(),
            "pid": os.getpid(),
            **self.snapshot(),
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # atomic: a reader never sees a partial dump
        return path


_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process-wide recorder, built lazily from the env knobs."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def reset_recorder() -> None:
    """Drop the singleton so the next get_recorder() re-reads the env knobs
    (tests)."""
    global _recorder
    with _recorder_lock:
        _recorder = None


def dump_for_exit(exit_code: int) -> str | None:
    """Write the flight-recorder state to disk before a lifecycle exit.

    Best effort: a dump failure must never block the exit it documents.
    Returns the path, or None when nothing was written (recorder off,
    empty, or a code outside `DUMP_EXIT_CODES`)."""
    if exit_code not in DUMP_EXIT_CODES:
        return None
    rec = get_recorder()
    if not rec.enabled or rec.recorded_total == 0:
        return None
    base = os.environ.get(TRACE_DUMP_DIR_ENV, "").strip() or tempfile.gettempdir()
    path = os.path.join(
        base, f"spotter-tpu-traces-pid{os.getpid()}-exit{exit_code}.json"
    )
    try:
        os.makedirs(base, exist_ok=True)
        rec.dump(path)
        logger.error("flight recorder dumped to %s (exit %d)", path, exit_code)
        return path
    except Exception:
        logger.exception("flight-recorder dump failed (exit %d)", exit_code)
        return None
