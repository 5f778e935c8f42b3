"""HTTP-edge glue for the tracing tier (the port's own copy of
spotter_tpu.obs.http, for the replica's handlers):

- request-id + traceparent extraction/minting, echoed on every response
  (success, 4xx/5xx, 429/503 sheds), so client-side correlation works no
  matter how the request died;
- `Server-Timing` emission: the replica's per-stage span totals ride back
  on the response, so an edge can merge them into one trace whose summed
  spans reconcile with the latency the client saw;
- the `/debug/traces` and `/debug/perf` handlers (admin-token-gated);
- `/metrics` content negotiation between the JSON view and the
  Prometheus text exposition.
"""

import os

from aiohttp import web

from spotter_tpu_torch.obs import prom
from spotter_tpu_torch.obs.recorder import FlightRecorder, get_recorder
from spotter_tpu_torch.obs.trace import (
    OTHER,
    REQUEST_ID_HEADER,
    TRACEPARENT_HEADER,
    Trace,
    begin_trace,
    new_request_id,
    traceparent_value,
)

ADMIN_TOKEN_ENV = "SPOTTER_TPU_ADMIN_TOKEN"
ADMIN_TOKEN_HEADER = "X-Admin-Token"

SERVER_TIMING_HEADER = "Server-Timing"


def admin_rejection(request: web.Request) -> web.Response | None:
    """401 when SPOTTER_TPU_ADMIN_TOKEN is set and the request lacks it.
    Read per request, so a rotated token takes effect without rebuilding
    the app."""
    token = os.environ.get(ADMIN_TOKEN_ENV, "")
    if not token:
        return None  # open mode: no token configured
    if request.headers.get(ADMIN_TOKEN_HEADER, "") == token:
        return None
    return web.json_response(
        {"error": f"admin endpoint requires {ADMIN_TOKEN_HEADER}", "status": 401},
        status=401,
    )


def begin_http_trace(request: web.Request) -> tuple[Trace | None, str]:
    """Start (or decline) the request trace from the incoming headers and
    install it in the handler's context. Returns (trace, request_id):
    request_id is minted when absent, present even with the recorder off,
    and must be echoed on whatever response the handler produces."""
    request_id = request.headers.get(REQUEST_ID_HEADER, "").strip()
    if not request_id:
        request_id = None
    trace = begin_trace(
        request_id=request_id,
        traceparent=request.headers.get(TRACEPARENT_HEADER),
        enabled=get_recorder().enabled,
    )
    if trace is not None:
        return trace, trace.request_id
    return None, request_id or new_request_id()


def finish_http_trace(
    trace: Trace | None,
    request_id: str,
    response: web.Response,
    recorder: FlightRecorder | None = None,
    error: str | None = None,
    server_timing: bool = False,
) -> web.Response:
    """Stamp correlation headers on the response and hand the completed
    trace to the flight recorder. `error` pins the trace; a 429/503 pins it
    as shed, any other 4xx/5xx as an error; `server_timing=True` adds the
    per-stage totals header."""
    response.headers[REQUEST_ID_HEADER] = request_id
    if trace is None:
        return response
    response.headers[TRACEPARENT_HEADER] = traceparent_value(trace)
    if error is not None:
        trace.set_error("error", error)
    elif response.status in (429, 503):
        trace.set_error("shed", f"HTTP {response.status}")
    elif response.status >= 400:
        trace.set_error("error", f"HTTP {response.status}")
    total_ms = trace.finish()
    if server_timing:
        totals = trace.stage_totals()
        if totals:
            # "other" = this hop's unattributed remainder (HTTP parse /
            # serialize, handler glue): reporting it keeps an upstream
            # merge tiling
            unattributed = total_ms - sum(totals.values())
            if unattributed > 0.0:
                totals[OTHER] = unattributed
            response.headers[SERVER_TIMING_HEADER] = ", ".join(
                f"{name};dur={dur:.3f}" for name, dur in totals.items()
            )
    (recorder or get_recorder()).record(trace)
    return response


def make_debug_traces_handler(recorder: FlightRecorder | None = None):
    """GET /debug/traces (admin-token-gated): the full flight-recorder
    snapshot, or `?request_id=<id>` / `?trace_id=<id>` for one request's
    trace(s) (404 when none matches)."""

    async def debug_traces(request: web.Request) -> web.Response:
        rejected = admin_rejection(request)
        if rejected is not None:
            return rejected
        rec = recorder or get_recorder()
        key = (
            request.query.get("request_id", "").strip()
            or request.query.get("trace_id", "").strip()
        )
        if key:
            matches = rec.lookup(key)
            return web.json_response(
                {"query": key, "traces": matches},
                status=200 if matches else 404,
            )
        return web.json_response(rec.snapshot())

    return debug_traces


def make_debug_perf_handler(metrics_getter):
    """GET /debug/perf (admin-token-gated): the device-efficiency ledger's
    wide view (obs/perf.py `debug_snapshot`): the top-K most expensive
    dispatches (their trace ids join /debug/traces), the capture-shape
    table, the memory gauges and the SLO burn detail. `metrics_getter`
    returns the serving Metrics, or None while the replica is loading.
    `?k=<n>` bounds the dispatch table."""

    async def debug_perf(request: web.Request) -> web.Response:
        rejected = admin_rejection(request)
        if rejected is not None:
            return rejected
        metrics = metrics_getter()
        if metrics is None:
            return web.json_response(
                {"error": "replica starting up", "status": 503}, status=503,
                headers={"Retry-After": "2"},
            )
        try:
            k = int(request.query.get("k", "0")) or None
        except ValueError:
            return web.Response(status=400, text="k must be an integer")
        return web.json_response(metrics.perf.debug_snapshot(k))

    return debug_perf


def metrics_response(request: web.Request, snapshot: dict) -> web.Response:
    """JSON by default; Prometheus text exposition behind
    `?format=prometheus` or `Accept: text/plain`."""
    if prom.wants_prometheus(
        request.query.get("format"), request.headers.get("Accept")
    ):
        return web.Response(
            text=prom.render(snapshot), content_type="text/plain",
            charset="utf-8", headers={"X-Prometheus-Version": "0.0.4"},
        )
    return web.json_response(snapshot)
