"""Observability of the port: request-scoped tracing (`trace`), the flight
recorder (`recorder`), the device-efficiency ledger (`perf`), the
detection comparator (`compare`), the Prometheus view (`prom`) and
trace-correlated JSON logs (`logs`). This root re-exports the stdlib-only
surface, as spotter_tpu.obs does; the aiohttp glue is imported explicitly
as `spotter_tpu_torch.obs.http`."""

from spotter_tpu_torch.obs.perf import (  # noqa: F401
    HBM_SAMPLE_ENV,
    PEAK_TFLOPS_ENV,
    PERF_LEDGER_ENV,
    SLO_TARGET_PCT_ENV,
    CompileLedger,
    HbmSampler,
    PerfLedger,
    SloBurn,
    peak_tflops_for,
    perf_enabled,
    sample_hbm_once,
)
from spotter_tpu_torch.obs.recorder import (  # noqa: F401
    DUMP_EXIT_CODES,
    TRACE_DUMP_DIR_ENV,
    TRACE_RING_ENV,
    TRACE_SLOWEST_K_ENV,
    FlightRecorder,
    dump_for_exit,
    get_recorder,
    reset_recorder,
)
from spotter_tpu_torch.obs.trace import (  # noqa: F401
    DECODE,
    DEVICE,
    ENGINE_STAGES,
    FETCH,
    H2D,
    NETWORK,
    OTHER,
    POSTPROCESS,
    QUEUE_WAIT,
    REQUEST_ID_HEADER,
    ROUTE,
    STAGES,
    TRACEPARENT_HEADER,
    Trace,
    batch_trace_id,
    begin_trace,
    current_trace,
    new_request_id,
    parse_traceparent,
    record_engine_spans,
    set_batch_traces,
    set_current_trace,
    span,
    trace_id_for_request,
    trace_stats,
    traceparent_value,
)
