"""Request-scoped tracing: trace context, spans and cross-hop propagation
(the port's own copy of spotter_tpu.obs.trace).

Stdlib only. One `Trace` is born per request at the first hop that sees it
(the standalone server when hit directly, or an edge in front of it),
propagates via `contextvars` through the async handler tree and into the
batcher's engine worker threads (`asyncio.to_thread` copies the context),
and crosses process boundaries as a W3C-compatible `traceparent` header
plus an `X-Request-ID` the client can quote back.

Span capture is a monotonic-clock read and a list append under the GIL;
when no trace is active (flight recorder off, or a code path outside a
request) every helper is a None check.

`STAGES` is the one list of stage names shared by trace spans, the
Metrics stage percentiles and the engine's stage windows.
"""

import contextvars
import hashlib
import os
import re
import threading
import time

from spotter_tpu_torch.testing import faults

# ---- stage vocabulary (one list, used by spans and Metrics) ----

ROUTE = "route"          # edge hop: pool pick + router overhead
FETCH = "fetch"          # detector: URL fetch
DECODE = "decode"        # host decode: PIL open/convert, and the engine's
                         # resize staging half
QUEUE_WAIT = "queue_wait"  # batcher: submit -> batch dispatch
H2D = "h2d"              # engine: host->device transfer enqueue
DEVICE = "device"        # engine: dispatch -> data on the host
POSTPROCESS = "postprocess"  # engine thresholding + detector draw/encode

STAGES = (ROUTE, FETCH, DECODE, QUEUE_WAIT, H2D, DEVICE, POSTPROCESS)

# Not pipeline stages, but part of "where did the time go":
# - OTHER: the self-measured remainder (total - sum(stages)) a server
#   reports in Server-Timing so upstream traces tile (HTTP parse/serialize
#   and handler overhead);
# - NETWORK: the edge-measured transport slice of a downstream call.
OTHER = "other"
NETWORK = "network"

# engine-side subset, in stage order (what Metrics.record_batch carries)
ENGINE_STAGES = (DECODE, H2D, DEVICE, POSTPROCESS)

TRACEPARENT_HEADER = "traceparent"
REQUEST_ID_HEADER = "X-Request-ID"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

# Debug-only allocation counters: the recorder-off path must create zero
# Span/Trace objects. Unlocked by design: a rare lost increment under thread
# races is acceptable for a debug stat, and "exactly zero" is race-free.
_traces_created = 0
_spans_created = 0


def trace_stats() -> dict:
    return {
        "traces_created": _traces_created,
        "spans_created": _spans_created,
    }


class Span:
    """One timed stage inside a trace. Times are milliseconds relative to
    the trace start, so a serialized trace is self-contained."""

    __slots__ = ("name", "start_ms", "duration_ms")

    def __init__(self, name: str, start_ms: float, duration_ms: float) -> None:
        global _spans_created
        self.name = name
        self.start_ms = start_ms
        self.duration_ms = duration_ms
        _spans_created += 1

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "start_ms": round(self.start_ms, 3),
            "duration_ms": round(self.duration_ms, 3),
        }


class Trace:
    """One request's trace: identity + an append-only span list.

    Appends happen from the handler task, per-image subtasks and the
    batcher's engine worker thread concurrently; `list.append` under the
    GIL plus the `_lock` on the mutators keeps the structure consistent.
    """

    def __init__(
        self,
        trace_id: str,
        request_id: str,
        parent_span_id: str | None = None,
    ) -> None:
        global _traces_created
        self.trace_id = trace_id
        self.request_id = request_id
        self.parent_span_id = parent_span_id
        self.span_id = os.urandom(8).hex()
        self.started_at = time.time()
        self._t0 = time.monotonic()
        self.spans: list[Span] = []
        self.status = "ok"
        self.error: str | None = None
        self.duration_ms: float | None = None
        self._lock = threading.Lock()
        _traces_created += 1

    # -- span capture --

    def add_span(self, name: str, t_start: float, t_end: float) -> None:
        """Append a span from absolute monotonic timestamps."""
        self.spans.append(
            Span(name, (t_start - self._t0) * 1e3, (t_end - t_start) * 1e3)
        )

    def add_span_ms(self, name: str, start_ms: float, duration_ms: float) -> None:
        """Append a span from pre-computed relative milliseconds (merged
        downstream Server-Timing entries land here with start 0)."""
        self.spans.append(Span(name, start_ms, duration_ms))

    def set_error(self, status: str, error: str) -> None:
        with self._lock:
            self.status = status
            self.error = error[:2000]

    def finish(self) -> float:
        """Stamp the total duration (idempotent: the first call wins, so a
        late finisher cannot shrink an already-recorded total)."""
        with self._lock:
            if self.duration_ms is None:
                self.duration_ms = (time.monotonic() - self._t0) * 1e3
            return self.duration_ms

    # -- serialization --

    def stage_totals(self) -> dict[str, float]:
        """Per-name summed durations (ms): the Server-Timing payload."""
        totals: dict[str, float] = {}
        for s in list(self.spans):
            totals[s.name] = totals.get(s.name, 0.0) + s.duration_ms
        return totals

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "started_at": self.started_at,
            "duration_ms": (
                round(self.duration_ms, 3) if self.duration_ms is not None else None
            ),
            "status": self.status,
            "error": self.error,
            "spans": [s.to_dict() for s in list(self.spans)],
        }


# ---- context propagation ----

_current: contextvars.ContextVar[Trace | None] = contextvars.ContextVar(
    "spotter_tpu_trace", default=None
)
# The batch the engine worker thread is serving: set by the batcher right
# before `asyncio.to_thread` (which copies the context), so engine-side
# stage spans fan out to every request trace in the batch.
_batch_traces: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "spotter_tpu_batch_traces", default=None
)


def current_trace() -> Trace | None:
    return _current.get()


def set_current_trace(trace: Trace | None) -> contextvars.Token:
    return _current.set(trace)


def new_request_id() -> str:
    return os.urandom(16).hex()


def trace_id_for_request(request_id: str) -> str:
    """Deterministic trace id from an X-Request-ID: a client that minted its
    own request id can locate the trace without having seen a traceparent."""
    return hashlib.sha256(request_id.encode()).hexdigest()[:32]


def parse_traceparent(value: str | None) -> tuple[str, str] | None:
    """(trace_id, parent_span_id) from a W3C traceparent, or None."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def traceparent_value(trace: Trace) -> str:
    """The header value for the outgoing hop: this trace's span is the
    downstream request's parent."""
    return f"00-{trace.trace_id}-{trace.span_id}-01"


def begin_trace(
    request_id: str | None = None,
    traceparent: str | None = None,
    enabled: bool = True,
) -> Trace | None:
    """Create (or decline to create) the request trace and install it in the
    current context. With the recorder off (`enabled=False`) this is the
    whole cost of tracing: one None check per helper downstream."""
    if not enabled:
        return None
    parent = parse_traceparent(traceparent)
    if request_id is None or not str(request_id).strip():
        request_id = new_request_id()
    request_id = str(request_id).strip()[:128]
    if parent is not None:
        trace = Trace(parent[0], request_id, parent_span_id=parent[1])
    else:
        trace = Trace(trace_id_for_request(request_id), request_id)
    set_current_trace(trace)
    return trace


class span:
    """`with span("fetch"):` records one stage on the ambient trace (or an
    explicit one). No active trace: no allocation, but the fault plan's
    `slow_stage` delay still applies, so latency tests get the same delay
    whether or not tracing captured it."""

    __slots__ = ("name", "trace", "_t0")

    def __init__(self, name: str, trace: Trace | None = None) -> None:
        self.name = name
        self.trace = trace

    def __enter__(self) -> "span":
        delay = faults.stage_delay_s(self.name)
        if delay > 0.0:
            time.sleep(delay)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tr = self.trace if self.trace is not None else _current.get()
        if tr is not None:
            tr.add_span(self.name, self._t0, time.monotonic())


# ---- batch fan-out (engine worker thread -> per-request traces) ----


def set_batch_traces(traces: list) -> None:
    """Called by the batcher before handing the batch to the worker thread;
    `asyncio.to_thread` copies the context, so the engine sees the list."""
    _batch_traces.set(traces or None)


def batch_trace_id() -> str | None:
    """The exemplar trace id for this engine batch (first traced item)."""
    traces = _batch_traces.get()
    return traces[0].trace_id if traces else None


def record_engine_spans(stages: list[tuple[str, float, float]]) -> None:
    """Fan the engine's per-batch stage windows (absolute monotonic
    (name, t_start, t_end) triples) out to every request trace riding in
    the current batch. A no-op outside a traced batch."""
    traces = _batch_traces.get()
    if not traces:
        return
    for tr in traces:
        for name, t_start, t_end in stages:
            tr.add_span(name, t_start, t_end)
